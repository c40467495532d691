"""Exact log-weight arithmetic for the dynamic modeling language's GFI —
the dominant reference test pattern (test/dsl/dynamic_dsl.jl:86-278): build a
tiny model, constrain addresses, call a GFI method, assert the weight equals
a by-hand sum of logpdf terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

import gen_tpu as gt
from gen_tpu import choicemap, gen, select

KEY = jax.random.PRNGKey(0)


def N(x, mu, std):
    return stats.norm.logpdf(float(x), float(mu), float(std))


@gen
def sub_model(mu):
    a = gt.normal(mu, 1.0) @ "a"
    return a


@gen
def outer_model(x):
    m = gt.normal(0.0, 2.0) @ "m"
    s = sub_model(m) @ "sub"
    y = gt.normal(s, 0.5) @ "y"
    return y


@gen
def branch_model():
    b = gt.bernoulli(0.3) @ "b"
    if b:
        return gt.normal(0.0, 1.0) @ "x"
    else:
        return gt.normal(10.0, 2.0) @ "y"


def test_simulate_score():
    tr = outer_model.simulate(KEY, (1.0,))
    m, a, y = tr["m"], tr[("sub", "a")], tr["y"]
    expected = N(m, 0, 2) + N(a, m, 1) + N(y, a, 0.5)
    np.testing.assert_allclose(tr.get_score(), expected, rtol=1e-12)
    assert tr.get_args() == (1.0,)
    assert tr.get_gen_fn() is outer_model
    # call return value accessible via address
    np.testing.assert_allclose(tr["sub"], a)


def test_generate_weight_hierarchical():
    cons = choicemap(y=1.5)
    cons.set_value(("sub", "a"), 0.7)
    tr, w = outer_model.generate(KEY, (1.0,), cons)
    m = tr["m"]
    expected_w = N(0.7, m, 1) + N(1.5, 0.7, 0.5)
    np.testing.assert_allclose(w, expected_w, rtol=1e-12)
    expected_score = N(m, 0, 2) + expected_w
    np.testing.assert_allclose(tr.get_score(), expected_score, rtol=1e-12)


def test_generate_unconstrained_weight_zero():
    tr, w = outer_model.generate(KEY, (1.0,))
    np.testing.assert_allclose(w, 0.0, atol=1e-14)


def test_propose():
    choices, w, retval = outer_model.propose(KEY, (1.0,))
    expected = (N(choices["m"], 0, 2) + N(choices[("sub", "a")], choices["m"], 1)
                + N(choices["y"], choices[("sub", "a")], 0.5))
    np.testing.assert_allclose(w, expected, rtol=1e-12)
    np.testing.assert_allclose(retval, choices["y"])


def test_assess_requires_all_choices():
    with pytest.raises(ValueError):
        outer_model.assess((1.0,), choicemap(y=1.0))


def test_assess_rejects_extra_choices():
    cons = choicemap(m=0.1, y=1.0, z=9.9)
    cons.set_value(("sub", "a"), 0.5)
    with pytest.raises(ValueError):
        outer_model.assess((1.0,), cons)


def test_project():
    tr = outer_model.simulate(KEY, (1.0,))
    m, a, y = tr["m"], tr[("sub", "a")], tr["y"]
    np.testing.assert_allclose(tr.project(select("m")), N(m, 0, 2), rtol=1e-12)
    np.testing.assert_allclose(tr.project(select("m", "y")),
                               N(m, 0, 2) + N(y, a, 0.5), rtol=1e-12)
    np.testing.assert_allclose(tr.project(select(("sub", "a"))),
                               N(a, m, 1), rtol=1e-12)
    np.testing.assert_allclose(tr.project(gt.ALL), tr.get_score(), rtol=1e-12)
    np.testing.assert_allclose(tr.project(gt.NONE), 0.0, atol=1e-14)


def test_update_constrained_and_downstream():
    tr, _ = outer_model.generate(KEY, (1.0,), choicemap(m=0.5, y=1.0))
    a = tr[("sub", "a")]
    new_tr, w, retdiff, discard = tr.update(KEY, choicemap(m=-0.5))
    # m constrained: logpdf(m') - logpdf(m); a retained but its args changed
    expected = ((N(-0.5, 0, 2) - N(0.5, 0, 2))
                + (N(a, -0.5, 1) - N(a, 0.5, 1)))
    np.testing.assert_allclose(w, expected, rtol=1e-12)
    np.testing.assert_allclose(discard["m"], 0.5)
    assert not discard.has_value("y")
    np.testing.assert_allclose(new_tr["y"], 1.0)


def test_update_new_args():
    @gen
    def m_model(mu):
        return gt.normal(mu, 1.0) @ "x"

    tr, _ = m_model.generate(KEY, (0.0,), choicemap(x=1.0))
    new_tr, w, _, discard = m_model.update(
        KEY, tr, (2.0,), (gt.UnknownChange,), choicemap())
    np.testing.assert_allclose(w, N(1.0, 2.0, 1) - N(1.0, 0.0, 1), rtol=1e-12)
    assert discard.is_empty()


def test_update_branch_flip_deletes_addresses():
    tr, _ = branch_model.generate(KEY, (), choicemap(b=True, x=1.0))
    new_tr, w, _, discard = tr.update(jax.random.PRNGKey(3), choicemap(b=False))
    y = new_tr["y"]
    # weight: new b + new y (fresh sample contributes its score... no —
    # fresh unconstrained y contributes nothing; but deleted x subtracts)
    expected = (np.log(0.7) - np.log(0.3)) - N(1.0, 0, 1)
    np.testing.assert_allclose(w, expected, rtol=1e-12)
    np.testing.assert_allclose(discard["b"], True)
    np.testing.assert_allclose(discard["x"], 1.0)
    assert not new_tr.get_choices().has_value("x")
    # score is the full new joint
    np.testing.assert_allclose(new_tr.get_score(),
                               np.log(0.7) + N(y, 10, 2), rtol=1e-12)


def test_update_unvisited_constraint_errors():
    tr, _ = branch_model.generate(KEY, (), choicemap(b=True, x=1.0))
    with pytest.raises(ValueError):
        tr.update(KEY, choicemap(y=0.0))  # y not visited when b stays True


def test_regenerate_selected():
    tr, _ = outer_model.generate(KEY, (1.0,), choicemap(m=0.5, y=1.0))
    a = tr[("sub", "a")]
    new_tr, w, _ = tr.regenerate(jax.random.PRNGKey(5), select("m"))
    m2 = new_tr["m"]
    assert not np.allclose(m2, 0.5)
    # weight: only unselected retained choices contribute score diffs
    expected = (N(a, m2, 1) - N(a, 0.5, 1))
    np.testing.assert_allclose(w, expected, rtol=1e-12)
    # y retained, same args -> cancels; a retained under sub
    np.testing.assert_allclose(new_tr[("sub", "a")], a)


def test_regenerate_branch_flip():
    tr, _ = branch_model.generate(KEY, (), choicemap(b=True, x=1.0))
    # regenerate b until it flips
    for seed in range(20):
        new_tr, w, _ = tr.regenerate(jax.random.PRNGKey(seed), select("b"))
        if not bool(new_tr["b"]):
            break
    else:
        pytest.fail("b never flipped")
    # x deleted (not subtracted for choices in regenerate), y fresh:
    np.testing.assert_allclose(w, 0.0, atol=1e-12)


def test_duplicate_address_errors():
    @gen
    def bad():
        gt.normal(0.0, 1.0) @ "x"
        gt.normal(0.0, 1.0) @ "x"

    with pytest.raises(ValueError):
        bad.simulate(KEY, ())


def test_address_prefix_conflict_errors():
    @gen
    def bad():
        gt.normal(0.0, 1.0) @ "x"
        gt.normal(0.0, 1.0) @ ("x", "y")

    with pytest.raises(ValueError):
        bad.simulate(KEY, ())


def test_splice_inline():
    @gen
    def inner():
        return gt.normal(0.0, 1.0) @ "z"

    @gen
    def outer():
        v = inner.inline()
        return gt.normal(v, 0.5) @ "w"

    tr = outer.simulate(KEY, ())
    # z spliced into outer's own address space
    z, w_ = tr["z"], tr["w"]
    np.testing.assert_allclose(tr.get_score(), N(z, 0, 1) + N(w_, z, 0.5),
                               rtol=1e-12)


def test_vectorized_choice_at_one_address():
    """An address may hold an array of iid draws — the accelerator-friendly pattern."""
    @gen
    def vec_model():
        x = gt.normal(jnp.zeros(5), 1.0) @ "x"
        return jnp.sum(x)

    tr = vec_model.simulate(KEY, ())
    x = np.asarray(tr["x"])
    assert x.shape == (5,)
    np.testing.assert_allclose(tr.get_score(), stats.norm.logpdf(x).sum(),
                               rtol=1e-12)


def test_gfi_under_jit_and_vmap():
    jitted_gen = jax.jit(lambda k, y: outer_model.generate(k, (1.0,),
                                                           choicemap(y=y)))
    tr, w = jitted_gen(KEY, 1.5)
    a = tr[("sub", "a")]
    np.testing.assert_allclose(w, N(1.5, a, 0.5), rtol=1e-10)

    keys = jax.random.split(KEY, 50)
    traces, ws = jax.vmap(lambda k: outer_model.generate(k, (1.0,),
                                                         choicemap(y=0.0)))(keys)
    assert ws.shape == (50,)
    assert traces.get_score().shape == (50,)
    # per-element consistency
    as_ = np.asarray(traces.get_choices()[("sub", "a")])
    expected = stats.norm.logpdf(0.0, as_, 0.5)
    np.testing.assert_allclose(np.asarray(ws), expected, rtol=1e-10)
