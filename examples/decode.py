"""Substitution-cipher decoding via MCMC.

Reference: /root/reference/examples/decode — recovering text enciphered
with an unknown substitution table using a bigram language model.

Design: both conditionals are *exact* and fully vectorized —
(1) given the plaintext, each cipher-table entry's posterior is an
independent categorical; (2) given the table, plaintext characters form a
Markov chain whose even/odd checkerboard blocks are conditionally
independent categoricals. The whole Gibbs sweep is a handful of fused
batched-categorical samples applied through ``trace.update``. Also
demonstrates authoring a custom :class:`Distribution` (the Markov chain).

Run: python examples/decode.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import choicemap, gen
from gen_tpu.dists.distribution import Distribution

ALPHABET = "abcdefghijklmnopqrstuvwxyz "
K = len(ALPHABET)
EMIS_EPS = 0.02

CORPUS = (
    "the quick brown fox jumps over the lazy dog and then the dog barks at "
    "the moon while the fox runs into the forest where the trees grow tall "
    "and the river flows to the sea and every morning the sun rises over "
    "the hills and the birds sing in the trees and people walk along the "
    "road to the market where they buy bread and fruit and talk about the "
    "weather and the harvest and the children play in the fields until the "
    "evening comes and the stars appear in the sky above the quiet town")

MESSAGE = ("the fox runs into the forest and the dog barks at the moon "
           "while the children play in the fields until the evening comes "
           "and the sun rises over the hills where the birds sing in the "
           "trees and the river flows to the sea while people walk along "
           "the road to the market and talk about the weather")


def _index(text):
    return np.array([ALPHABET.index(c) for c in text])


def bigram_stats():
    idx = _index(CORPUS)
    counts = np.ones((K, K))  # Laplace smoothing
    for a, b in zip(idx[:-1], idx[1:]):
        counts[a, b] += 1
    B = counts / counts.sum(axis=1, keepdims=True)
    pi = np.bincount(idx, minlength=K).astype(float) + 1
    return jnp.asarray(B), jnp.asarray(pi / pi.sum())


class MarkovChain(Distribution):
    """First-order Markov chain over K symbols: a custom distribution whose
    logpdf is one gather+sum and whose sampler is a scan."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True, True, False)

    def sample(self, key, B, pi, length):
        k0, krest = jax.random.split(key)
        first = jax.random.categorical(k0, jnp.log(pi))

        def step(prev, k):
            nxt = jax.random.categorical(k, jnp.log(B[prev]))
            return nxt, nxt

        _, rest = jax.lax.scan(step, first,
                               jax.random.split(krest, length - 1))
        return jnp.concatenate([first[None], rest])

    def logpdf(self, v, B, pi, length):
        v = jnp.asarray(v)
        lp0 = jnp.log(pi[v[0]])
        trans = jnp.log(B[v[:-1], v[1:]])
        return lp0 + jnp.sum(trans)


markov_chain = MarkovChain()


@gen
def decode_model(B, pi, T):
    enc = gt.categorical(jnp.ones((K, K)) / K) @ "enc"       # cipher table
    plain = markov_chain(B, pi, T) @ "plain"                  # latent text
    probs = ((1 - EMIS_EPS) * jax.nn.one_hot(enc[plain], K)
             + EMIS_EPS / K)
    gt.categorical(probs) @ "cipher"
    return plain


def gibbs_enc(key, trace, cipher):
    """Exact conditional for the cipher table: entries are independent
    categoricals given the plaintext."""
    plain = trace["plain"]
    # counts[l, s] = #positions where plain==l and cipher==s
    counts = jnp.zeros((K, K)).at[plain, cipher].add(1.0)
    logits = counts * jnp.log((1 - EMIS_EPS) + EMIS_EPS / K) \
        + (counts.sum(axis=1, keepdims=True) - counts) * jnp.log(EMIS_EPS / K)
    new_enc = jax.random.categorical(key, logits).astype(trace["enc"].dtype)
    new_trace, _, _, _ = trace.update(None, choicemap(enc=new_enc))
    return new_trace


def gibbs_plain_block(key, trace, cipher, B, pi, parity):
    """Exact checkerboard conditional for plaintext characters."""
    plain = trace["plain"]
    enc = trace["enc"]
    T = plain.shape[0]
    sym = jnp.arange(K)
    # emission term per position/symbol
    emis = jnp.log((1 - EMIS_EPS) * (enc[sym][None, :] == cipher[:, None])
                   + EMIS_EPS / K)
    logB = jnp.log(B)
    left = jnp.where(jnp.arange(T)[:, None] == 0,
                     jnp.log(pi)[None, :],
                     logB[plain[jnp.maximum(jnp.arange(T) - 1, 0)], :])
    right_idx = jnp.minimum(jnp.arange(T) + 1, T - 1)
    right = jnp.where(jnp.arange(T)[:, None] == T - 1,
                      0.0,
                      logB[:, plain[right_idx]].T)
    logits = left + right + emis
    proposal = jax.random.categorical(key, logits).astype(plain.dtype)
    mask = (jnp.arange(T) % 2) == parity
    new_plain = jnp.where(mask, proposal, plain)
    new_trace, _, _, _ = trace.update(None, choicemap(plain=new_plain))
    return new_trace


def transposition_move(key, trace, cipher):
    """Diaconis-style table transposition: swap two cipher-table entries and
    relabel the plaintext consistently — a joint discrete involution, so
    acceptance is just the update weight. This is the move that escapes the
    local optima latent-plaintext Gibbs locks into."""
    from gen_tpu.inference import mh_accept, select_trace
    ka, kacc = jax.random.split(key)
    ab = jax.random.randint(ka, (2,), 0, K)
    a, b = ab[0], ab[1]
    enc = trace["enc"]
    plain = trace["plain"]
    new_enc = enc.at[a].set(enc[b]).at[b].set(enc[a])
    new_plain = jnp.where(plain == a, b, jnp.where(plain == b, a, plain))
    new_trace, w, _, _ = trace.update(
        None, choicemap(enc=new_enc, plain=new_plain))
    accept = mh_accept(kacc, w)
    return select_trace(accept, new_trace, trace)


def main(n_sweeps=600, n_restarts=16, seed=0):
    B, pi = bigram_stats()
    rng = np.random.default_rng(seed)
    true_plain = _index(MESSAGE)
    true_table = rng.permutation(K)
    cipher = jnp.asarray(true_table[true_plain])
    T = len(true_plain)

    key = jax.random.PRNGKey(seed)

    def one_sweep(trace, k):
        ks = jax.random.split(k, 43)
        trace = gibbs_enc(ks[0], trace, cipher)
        trace = gibbs_plain_block(ks[1], trace, cipher, B, pi, 0)
        trace = gibbs_plain_block(ks[2], trace, cipher, B, pi, 1)
        for i in range(3, 43):
            trace = transposition_move(ks[i], trace, cipher)
        return trace

    @jax.jit
    def run_chain(k):
        k0, krest = jax.random.split(k)
        trace, _ = decode_model.generate(k0, (B, pi, T),
                                         choicemap(cipher=cipher))

        def body(tr, sk):
            return one_sweep(tr, sk), None

        trace, _ = jax.lax.scan(body, trace,
                                jax.random.split(krest, n_sweeps))
        return trace.get_score(), trace["plain"]

    # independent restarts vmapped; keep the best-scoring chain
    keys = jax.random.split(key, n_restarts)
    scores, plains = jax.vmap(run_chain)(keys)
    best = int(jnp.argmax(scores))
    plain = np.asarray(plains[best])
    decoded = "".join(ALPHABET[int(c)] for c in plain)
    acc = float(np.mean(plain == true_plain))
    print(f"best of {n_restarts} chains (score {float(scores[best]):.1f}):")
    print(f"decoded:  {decoded[:64]}...")
    print(f"original: {MESSAGE[:64]}...")
    print(f"character accuracy: {acc:.2%}")
    assert acc > 0.9, acc
    print("decode example OK")


if __name__ == "__main__":
    main()
