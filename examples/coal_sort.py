"""Coal changepoint RJMCMC, sorted-changepoint parameterization.

Reference: /root/reference/examples/coal/coal_sort.jl (Green 1995 §4 in the
"unsorted changepoints + sort inside the model" formulation) and
poisson_process.jl (the piecewise-homogeneous Poisson-process likelihood
over raw event times — ported as gen_tpu.piecewise_poisson_process).

The distinctive features of this second RJMCMC parameterization, vs the
binned-counts arena in examples/coal.py:

* The model addresses changepoints by UNSORTED slot index and sorts them
  internally; rate slot i is the rate of the segment immediately before the
  i'th unsorted changepoint, slot k is the final segment's rate
  (coal_sort.jl:41-65).
* Green's weighted-geometric-mean birth/death split of the rate at the
  insertion point, a genuinely non-unit-Jacobian trans-dimensional move
  (coal_sort.jl:244-271; |det J| = (h_prev + h_next)^2 / h_cur).
* A permutation move that swaps the last unsorted slot with a random other
  slot, so the always-delete-the-last-slot death move mixes over which
  actual changepoint dies (coal_sort.jl:389-404).
* A position move bounded by the sorted neighbors (coal_sort.jl:175-218).

Design: fixed-shape arena (K_MAX changepoint slots, K_MAX + 1
rate slots; ``k`` chooses how many are active; inactive changepoint slots
pin to t_end inside the model so their segments have zero length). Two
sampler surfaces:

1. ``birth_death`` / ``rate_involution`` as @transform involutions through
   the trace-translator DSL (the reference's @bijection programs), with
   the Jacobian computed by jacfwd — validated against the analytic Green
   determinant.
2. A fully branchless vmap/scan sweep (one-hot slot writes, where-masked
   move selection) for many-chain inference, gated on a semi-exact
   posterior over k (rates integrated analytically by Gamma-Poisson
   conjugacy, positions Monte-Carlo integrated).

Run: python examples/coal_sort.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    # must run BEFORE the first array op (module-level K_PRIOR below
    # initializes the backend): tiny changepoint models want CPU, and x64
    # keeps the Green split/merge inside the involution round-trip
    # checker's 1e-5 tolerance (f32 sits right at the edge)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import gen_tpu as gt
from gen_tpu import choicemap, gen
from gen_tpu.inference import mh_accept, mh_involutive, select_trace, transform

K_MAX = 6
T_END = 100.0
RATE_BETA = 1.0          # exponential prior rate on segment heights
K_POISSON_MEAN = 3.0     # truncated-Poisson prior on k

from scipy.stats import poisson as _sp_poisson
_K_PRIOR = _sp_poisson.pmf(np.arange(K_MAX + 1), K_POISSON_MEAN)
_K_PRIOR = _K_PRIOR / _K_PRIOR.sum()
K_PRIOR = jnp.asarray(_K_PRIOR, jnp.float32)


@gen
def coal_sort_model(t_end):
    k = gt.categorical(K_PRIOR) @ "k"
    # unsorted changepoint slots, iid uniform — sorted INSIDE the model
    upos = gt.uniform(jnp.zeros(K_MAX), t_end) @ "unsorted_changept"
    rates = gt.exponential(jnp.full(K_MAX + 1, RATE_BETA)) @ "unsorted_rate"
    active = jnp.arange(K_MAX) < k
    masked = jnp.where(active, upos, t_end)   # inactive slots: empty segments
    order = jnp.argsort(masked)               # sorted_to_unsorted
    bounds = jnp.concatenate(
        [jnp.zeros(1), masked[order], jnp.full(1, t_end)])
    # segment j < k gets the rate slot of its following (sorted) changepoint;
    # segments >= k share the last-rate slot k (those past k are zero-length)
    seg_idx = jnp.where(jnp.arange(K_MAX + 1) < k,
                        jnp.concatenate([order, jnp.zeros(1, order.dtype)]),
                        k)
    gt.piecewise_poisson_process(bounds, rates[seg_idx]) @ "events"
    return k


def make_dataset(seed=1):
    """Events from true changepoints (30, 70), rates (0.6, 2.5, 0.9)."""
    rng = np.random.default_rng(seed)
    events = []
    for lo, hi, rate in [(0.0, 30.0, 0.6), (30.0, 70.0, 2.5),
                         (70.0, T_END, 0.9)]:
        n = rng.poisson(rate * (hi - lo))
        events.append(rng.uniform(lo, hi, n))
    return jnp.sort(jnp.asarray(np.concatenate(events), jnp.float32))


# -- proposal-probability helpers ---------------------------------------------

def _log_pb(k):
    """log P(propose birth | k): forced birth at k=0, forced death at K_MAX."""
    return jnp.where(k == 0, 0.0,
                     jnp.where(k >= K_MAX, -jnp.inf, jnp.log(0.5)))


def _log_pd(k):
    return jnp.where(k == 0, -jnp.inf,
                     jnp.where(k >= K_MAX, 0.0, jnp.log(0.5)))


def _neighbors(cp, mask, x):
    """(cp_prev, cp_next, idx_next, has_next) of x among masked-in slots."""
    below = mask & (cp < x)
    above = mask & (cp >= x)
    cp_prev = jnp.maximum(jnp.max(jnp.where(below, cp, -jnp.inf)), 0.0)
    cp_next = jnp.minimum(jnp.min(jnp.where(above, cp, jnp.inf)), T_END)
    idx_next = jnp.argmin(jnp.where(above, cp, jnp.inf))
    return cp_prev, cp_next, idx_next, jnp.any(above)


def _green_split(h_cur, u, d_prev, d_next):
    """Green's weighted-geometric rate split (coal_sort.jl:244-257)."""
    d_tot = d_prev + d_next
    log_ratio = jnp.log1p(-u) - jnp.log(u)
    h_prev = jnp.exp(jnp.log(h_cur) - (d_next / d_tot) * log_ratio)
    h_next = jnp.exp(jnp.log(h_cur) + (d_prev / d_tot) * log_ratio)
    return h_prev, h_next


def _green_merge(h_prev, h_next, d_prev, d_next):
    """Inverse of the split (coal_sort.jl:259-271)."""
    d_tot = d_prev + d_next
    h_cur = jnp.exp((d_prev / d_tot) * jnp.log(h_prev)
                    + (d_next / d_tot) * jnp.log(h_next))
    u = h_prev / (h_prev + h_next)
    return h_cur, u


# -- branchless vectorized moves ----------------------------------------------

def birth_death_move(key, trace):
    """Green birth/death as ONE branchless update: both branches' slot
    rewrites are computed with one-hot masks and where-selected, so the move
    jits and vmaps. Acceptance = model update weight + move-choice ratio +
    the analytic Jacobian (the fresh-inactive-slot prior terms inside the
    update weight cancel the matching Jacobian factors — kept explicit on
    both sides for clarity)."""
    kb, k1, k2, ka = jax.random.split(key, 4)
    k = trace["k"]
    cp = trace["unsorted_changept"]
    rates = trace["unsorted_rate"]
    u1 = jax.random.uniform(k1)
    u2 = jax.random.uniform(k2, minval=1e-6, maxval=1.0 - 1e-6)
    do_birth = jnp.where(k == 0, True,
                         jnp.where(k >= K_MAX, False,
                                   jax.random.bernoulli(kb)))
    ar = jnp.arange(K_MAX + 1)
    arc = jnp.arange(K_MAX)
    kc = jnp.clip(k, 0, K_MAX - 1)          # slot written by birth
    kd = jnp.clip(k - 1, 0, K_MAX - 1)      # slot deleted by death

    # ---- birth quantities ----
    cp_new = u1 * T_END
    b_prev, b_next, b_idx, b_has = _neighbors(cp, arc < k, cp_new)
    h_idx_b = jnp.where(b_has, b_idx, k)
    h_cur_b = rates[h_idx_b]
    hp_b, hn_b = _green_split(h_cur_b, u2, cp_new - b_prev, b_next - cp_new)
    r_old = rates[jnp.clip(k + 1, 0, K_MAX)]
    birth_rates = jnp.where(ar == k + 1,
                            jnp.where(b_has, rates[jnp.clip(k, 0, K_MAX)],
                                      hn_b), rates)
    birth_rates = jnp.where(ar == k, hp_b, birth_rates)
    birth_rates = jnp.where((ar == b_idx) & b_has, hn_b, birth_rates)
    birth_cp = jnp.where(arc == k, cp_new, cp)
    logJ_birth = (jnp.log(hp_b * hn_b / (h_cur_b * u2 * (1.0 - u2)))
                  + jnp.log(RATE_BETA) - RATE_BETA * r_old)
    la_birth = _log_pd(k + 1) - _log_pb(k) + logJ_birth

    # ---- death quantities (delete slot k-1) ----
    cp_del = cp[kd]
    d_prevv, d_nextv, d_idx, d_has = _neighbors(cp, arc < k - 1, cp_del)
    h_prev_d = rates[kd]
    h_next_d = jnp.where(d_has, rates[d_idx], rates[jnp.clip(k, 0, K_MAX)])
    hc_d, u2rec = _green_merge(h_prev_d, h_next_d,
                               cp_del - d_prevv, d_nextv - cp_del)
    r_new = -jnp.log1p(-u2) / RATE_BETA
    death_rates = jnp.where(ar == kd,
                            jnp.where(d_has, rates[jnp.clip(k, 0, K_MAX)],
                                      hc_d), rates)
    death_rates = jnp.where((ar == d_idx) & d_has, hc_d, death_rates)
    death_rates = jnp.where(ar == k, r_new, death_rates)
    death_cp = jnp.where(arc == kd, u1 * T_END, cp)
    logJ_death = (jnp.log(hc_d * u2rec * (1.0 - u2rec) / (h_prev_d * h_next_d))
                  - jnp.log(RATE_BETA) - jnp.log1p(-u2))
    la_death = _log_pb(k - 1) - _log_pd(k) + logJ_death

    new_k = jnp.where(do_birth, jnp.minimum(k + 1, K_MAX),
                      jnp.maximum(k - 1, 0))
    cons = gt.ChoiceMap()
    cons.set_value("k", new_k)
    cons.set_value("unsorted_changept", jnp.where(do_birth, birth_cp,
                                                  death_cp))
    cons.set_value("unsorted_rate", jnp.where(do_birth, birth_rates,
                                              death_rates))
    new_trace, w, _, _ = trace.update(None, cons)
    log_alpha = w + jnp.where(do_birth, la_birth, la_death)
    accept = mh_accept(ka, log_alpha)
    return select_trace(accept, new_trace, trace), accept


def rate_move(key, trace):
    """Scaled-uniform multiplicative rate move on a random active slot
    (coal_sort.jl:110-145): new ~ U(h/2, 2h); log|J| = log h - log h'."""
    ki, ku, ka = jax.random.split(key, 3)
    k = trace["k"]
    rates = trace["unsorted_rate"]
    i = jax.random.randint(ki, (), 0, K_MAX + 1) % (k + 1)
    u = jax.random.uniform(ku)
    h_old = rates[i]
    h_new = h_old / 2.0 + u * 1.5 * h_old
    cons = gt.ChoiceMap()
    cons.set_value("unsorted_rate",
                   jnp.where(jnp.arange(K_MAX + 1) == i, h_new, rates))
    new_trace, w, _, _ = trace.update(None, cons)
    accept = mh_accept(ka, w + jnp.log(h_old) - jnp.log(h_new))
    return select_trace(accept, new_trace, trace), accept


def position_move(key, trace):
    """Move a random active changepoint within its sorted neighbors
    (coal_sort.jl:175-218); the neighbors don't change, so |J| = 1."""
    ki, ku, ka = jax.random.split(key, 3)
    k = trace["k"]
    cp = trace["unsorted_changept"]
    i = jax.random.randint(ki, (), 0, K_MAX) % jnp.maximum(k, 1)
    others = (jnp.arange(K_MAX) < k) & (jnp.arange(K_MAX) != i)
    lo, hi, _, _ = _neighbors(cp, others, cp[i])
    new_pos = lo + jax.random.uniform(ku) * (hi - lo)
    cons = gt.ChoiceMap()
    cons.set_value("unsorted_changept",
                   jnp.where(jnp.arange(K_MAX) == i, new_pos, cp))
    new_trace, w, _, _ = trace.update(None, cons)
    accept = mh_accept(ka, w) & (k > 0)
    return select_trace(accept, new_trace, trace), accept


def permutation_move(key, trace):
    """Swap unsorted slot j with slot k-1 (cp AND rate) so the
    delete-last-slot death move mixes over every changepoint
    (coal_sort.jl:389-404). Deterministic involution, |J| = 1, and the
    density only depends on the sorted configuration, so w == 0 and the
    move always accepts — still routed through MH for safety."""
    kj, ka = jax.random.split(key)
    k = trace["k"]
    cp = trace["unsorted_changept"]
    rates = trace["unsorted_rate"]
    j = jax.random.randint(kj, (), 0, K_MAX) % jnp.maximum(k - 1, 1)
    last = jnp.clip(k - 1, 0, K_MAX - 1)
    arc = jnp.arange(K_MAX)
    ar = jnp.arange(K_MAX + 1)
    new_cp = jnp.where(arc == j, cp[last],
                       jnp.where(arc == last, cp[j], cp))
    new_rates = jnp.where(ar == j, rates[last],
                          jnp.where(ar == last, rates[j], rates))
    cons = gt.ChoiceMap()
    cons.set_value("unsorted_changept", new_cp)
    cons.set_value("unsorted_rate", new_rates)
    new_trace, w, _, _ = trace.update(None, cons)
    accept = mh_accept(ka, w) & (k > 1)
    return select_trace(accept, new_trace, trace), accept


def refresh_inactive(key, trace):
    """Exact Gibbs on inactive arena slots (full conditional = prior)."""
    k = trace["k"]
    kp, kh = jax.random.split(key)
    fresh_pos = jax.random.uniform(kp, (K_MAX,)) * T_END
    fresh_h = jax.random.exponential(kh, (K_MAX + 1,)) / RATE_BETA
    cons = gt.ChoiceMap()
    cons.set_value("unsorted_changept",
                   jnp.where(jnp.arange(K_MAX) >= k, fresh_pos,
                             trace["unsorted_changept"]))
    cons.set_value("unsorted_rate",
                   jnp.where(jnp.arange(K_MAX + 1) > k, fresh_h,
                             trace["unsorted_rate"]))
    new_trace, _, _, _ = trace.update(None, cons)
    return new_trace


# -- transform-DSL involutions (the reference's @bijection surface) -----------

@gen
def rate_proposal(tr):
    # eager-mode proposal: pick an ACTIVE rate slot (coal_sort.jl:110-121)
    k = int(tr["k"])
    gt.uniform_discrete(0, k) @ "i"
    gt.uniform(0.0, 1.0) @ "new_rate_scaled"


@transform
def rate_involution(ctx):
    """coal_sort.jl:127-141: scale the chosen rate into [h/2, 2h]; the
    reverse aux coordinate is recovered so jacfwd sees the full 2x2 block
    and reproduces |J| = h_old / h_new.

    NOTE (transform-DSL rule): Python-level control flow may branch only on
    DISCRETE reads — continuous reads are re-run under jacfwd as tracers,
    so everything derived from them stays jnp-level (where/one-hot)."""
    i = int(ctx.aux_in.discrete["i"])
    ctx.aux_out.discrete["i"] = i
    rates = ctx.model_in["unsorted_rate"]
    u = ctx.aux_in["new_rate_scaled"]
    cur = rates[i]
    new = cur / 2.0 + u * (2.0 * cur - cur / 2.0)
    ctx.model_out["unsorted_rate"] = \
        jnp.where(jnp.arange(K_MAX + 1) == i, new, rates)
    ctx.aux_out["new_rate_scaled"] = (cur - new / 2.0) / (1.5 * new)


@gen
def birth_death_proposal(tr):
    # is_birth is only sampled where both moves are possible
    # (coal_sort.jl:230-242; forced birth at k=0, forced death at K_MAX)
    k = int(tr["k"])
    if 0 < k < K_MAX:
        gt.bernoulli(0.5) @ "is_birth"
    gt.uniform(0.0, 1.0) @ "cp_scaled"
    gt.uniform(0.0, 1.0) @ "u"


@transform
def birth_death_involution(ctx):
    """coal_sort.jl:279-375 on the fixed arena. Both directions move the
    full (state, aux) point; jacfwd computes the Green determinant
    automatically (validated against the analytic
    (h_prev + h_next)^2 / h_cur in tests/test_examples.py). Python branches
    only on discrete reads; neighbor indices derived from continuous
    changepoints stay jnp-level."""
    k = int(ctx.model_in.discrete["k"])
    if k == 0:
        is_birth = True
    elif k >= K_MAX:
        is_birth = False
    else:
        is_birth = bool(ctx.aux_in.discrete["is_birth"])
    cp = ctx.model_in["unsorted_changept"]
    rates = ctx.model_in["unsorted_rate"]
    u1 = ctx.aux_in["cp_scaled"]
    u2 = ctx.aux_in["u"]
    ar = jnp.arange(K_MAX + 1)
    arc = jnp.arange(K_MAX)
    if is_birth:
        cp_new = u1 * T_END
        lo, hi, idx, has = _neighbors(cp, arc < k, cp_new)
        h_idx = jnp.where(has, idx, k)
        h_cur = rates[h_idx]
        hp, hn = _green_split(h_cur, u2, cp_new - lo, hi - cp_new)
        r_old = rates[k + 1]
        new_rates = jnp.where(ar == k + 1,
                              jnp.where(has, rates[k], hn), rates)
        new_rates = jnp.where(ar == k, hp, new_rates)
        new_rates = jnp.where((ar == h_idx) & has, hn, new_rates)
        ctx.model_out.discrete["k"] = k + 1
        ctx.model_out["unsorted_changept"] = \
            jnp.where(arc == k, cp_new, cp)
        ctx.model_out["unsorted_rate"] = new_rates
        if 0 < k + 1 < K_MAX:
            ctx.aux_out.discrete["is_birth"] = False
        ctx.aux_out["cp_scaled"] = cp[k] / T_END
        ctx.aux_out["u"] = 1.0 - jnp.exp(-RATE_BETA * r_old)
    else:
        kd = k - 1
        cp_del = cp[kd]
        lo, hi, idx, has = _neighbors(cp, arc < kd, cp_del)
        h_prev = rates[kd]
        h_idx = jnp.where(has, idx, k)
        h_next = rates[h_idx]
        hc, u2rec = _green_merge(h_prev, h_next, cp_del - lo, hi - cp_del)
        r_new = -jnp.log1p(-u2) / RATE_BETA
        new_rates = jnp.where(ar == kd,
                              jnp.where(has, rates[k], hc), rates)
        new_rates = jnp.where((ar == h_idx) & has, hc, new_rates)
        new_rates = jnp.where(ar == k, r_new, new_rates)
        ctx.model_out.discrete["k"] = kd
        ctx.model_out["unsorted_changept"] = \
            jnp.where(arc == kd, u1 * T_END, cp)
        ctx.model_out["unsorted_rate"] = new_rates
        if 0 < kd < K_MAX:
            ctx.aux_out.discrete["is_birth"] = True
        ctx.aux_out["cp_scaled"] = cp_del / T_END
        ctx.aux_out["u"] = u2rec


# -- samplers -----------------------------------------------------------------

def dsl_sweep(key, trace):
    """Single-chain sweep through the transform-DSL involutions (round-trip
    checked), mirroring coal_sort.jl's mcmc_step."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    trace, _ = mh_involutive(k1, trace, rate_proposal, (), rate_involution,
                             check=True)
    if int(trace["k"]) > 0:
        trace, _ = position_move(k2, trace)
    if int(trace["k"]) > 1:
        trace, _ = permutation_move(k3, trace)
    trace, _ = mh_involutive(k4, trace, birth_death_proposal, (),
                             birth_death_involution, check=True)
    return trace


def vectorized_chains(events, n_chains=64, n_sweeps=3000, seed=0):
    """Many-chain branchless sampler: the whole run is one jitted
    lax.scan over sweeps with chains vmapped inside."""
    obs = choicemap(events=events)
    key = jax.random.PRNGKey(seed)
    k_init, k_run = jax.random.split(key)
    init_keys = jax.random.split(k_init, n_chains)
    traces, _ = jax.vmap(
        lambda k: coal_sort_model.generate(k, (T_END,), obs))(init_keys)

    def chain_sweep(key, trace):
        ks = jax.random.split(key, 9)
        trace = refresh_inactive(ks[0], trace)
        for i in range(1, 5):
            trace, _ = birth_death_move(ks[i], trace)
        trace, _ = rate_move(ks[5], trace)
        trace, _ = rate_move(ks[6], trace)
        trace, _ = position_move(ks[7], trace)
        trace, _ = permutation_move(ks[8], trace)
        return trace

    @jax.jit
    def run(traces, key):
        def body(trs, sk):
            ks = jax.vmap(lambda i: jax.random.fold_in(sk, i))(
                jnp.arange(n_chains))
            trs = jax.vmap(chain_sweep)(ks, trs)
            return trs, jax.vmap(lambda t: t["k"])(trs)
        return jax.lax.scan(body, traces, jax.random.split(key, n_sweeps))

    _, k_hist = run(traces, k_run)
    return np.asarray(k_hist)


def exact_k_posterior(events, n_mc=200_000, seed=0):
    """Semi-exact posterior over k: rates integrate analytically
    (Exponential-prior / Poisson-process conjugacy per segment:
    int h^N e^{-h L} b e^{-b h} dh = b N! / (L + b)^{N+1}); positions
    are Monte-Carlo integrated over their uniform prior."""
    from jax.scipy.special import gammaln, logsumexp
    ev = jnp.asarray(events)

    def logml(pos_sorted):
        B, k = pos_sorted.shape
        seg = jnp.sum(ev[None, :, None] > pos_sorted[:, None, :], axis=2)
        bounds = jnp.concatenate(
            [jnp.zeros((B, 1)), pos_sorted, jnp.full((B, 1), T_END)], axis=1)
        lens = jnp.diff(bounds, axis=1)
        out = jnp.zeros(B)
        for j in range(k + 1):
            n = jnp.sum(seg == j, axis=1)
            out = out + (jnp.log(RATE_BETA) + gammaln(n + 1.0)
                         - (n + 1.0) * jnp.log(lens[:, j] + RATE_BETA))
        return out

    key = jax.random.PRNGKey(seed)
    logZ = {}
    for k in range(K_MAX + 1):
        if k == 0:
            logZ[0] = float(logml(jnp.zeros((1, 0)))[0])
            continue
        key, sub = jax.random.split(key)
        pos = jnp.sort(jax.random.uniform(sub, (n_mc, k)) * T_END, axis=1)
        logZ[k] = float(logsumexp(logml(pos)) - np.log(n_mc))
    lw = {k: v + np.log(_K_PRIOR[k]) for k, v in logZ.items()}
    mx = max(lw.values())
    w = {k: np.exp(v - mx) for k, v in lw.items()}
    z = sum(w.values())
    return {k: v / z for k, v in w.items()}


def load_real_dataset():
    """The real 1851-1962 disaster EVENT TIMES the reference's coal_sort
    loads (reference coal_sort.jl:466-475; data vendored at
    examples/data/coal.csv): dates shifted to 0 and scaled to
    [0, T_END] — the reference scales to days, we scale to the model's
    fixed time axis; the k/location posterior is reported back in
    calendar years via the returned ``to_calendar``."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "coal.csv")
    dates = np.loadtxt(path)
    lo, hi = dates.min(), dates.max()
    events = (dates - lo) / (hi - lo) * (T_END * (1 - 1e-6))

    def to_calendar(t):
        return lo + np.asarray(t) / T_END * (hi - lo)

    return jnp.sort(jnp.asarray(events, jnp.float32)), to_calendar


def main_real(seed=0, n_chains=64, n_sweeps=3000, tv_gate=0.12):
    """REAL-data mode (VERDICT r3 item 4): the event-time RJMCMC on the
    actual mining-disaster record, k-posterior gated against the
    semi-exact reference on the same data."""
    events, to_cal = load_real_dataset()
    print(f"real coal data: {events.shape[0]} events")
    exact = exact_k_posterior(events)
    print("semi-exact k posterior:",
          {k: round(v, 3) for k, v in exact.items()})
    k_hist = vectorized_chains(events, n_chains=n_chains,
                               n_sweeps=n_sweeps, seed=seed)
    post = k_hist[n_sweeps // 2:].ravel()
    emp = {k: float(np.mean(post == k)) for k in range(K_MAX + 1)}
    print("sampled k posterior:   ",
          {k: round(v, 3) for k, v in emp.items()})
    tv = 0.5 * sum(abs(emp[k] - exact[k]) for k in exact)
    print(f"total-variation distance to semi-exact: {tv:.3f}")
    assert tv < tv_gate, (emp, exact)
    print("coal_sort real-data example OK")
    return emp


def main(seed=0):
    events = make_dataset()
    print(f"{events.shape[0]} events on [0, {T_END}]")
    obs = choicemap(events=events)

    # single-chain transform-DSL demo (round-trip checks ON)
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    trace, _ = coal_sort_model.generate(k_init, (T_END,), obs)
    ks = []
    for _ in range(300):
        key, sub = jax.random.split(key)
        trace = dsl_sweep(sub, trace)
        ks.append(int(trace["k"]))
    from collections import Counter
    print("DSL single-chain k histogram (300 sweeps):",
          dict(sorted(Counter(ks).items())))

    # many-chain branchless sampler vs semi-exact posterior
    exact = exact_k_posterior(events)
    print("semi-exact k posterior:",
          {k: round(v, 3) for k, v in exact.items()})
    k_hist = vectorized_chains(events, n_chains=64, n_sweeps=3000)
    post = k_hist[1500:].ravel()
    emp = {k: float(np.mean(post == k)) for k in range(K_MAX + 1)}
    print("sampled k posterior:   ",
          {k: round(v, 3) for k, v in emp.items()})
    tv = 0.5 * sum(abs(emp[k] - exact[k]) for k in exact)
    print(f"total-variation distance to semi-exact: {tv:.3f}")
    assert tv < 0.12, (emp, exact)
    print("coal_sort example OK")


if __name__ == "__main__":
    import sys
    if "--real" in sys.argv:
        main_real()
    else:
        main()
