"""Preemption-safe, self-healing inference driving (SURVEY §5.3: failure
detection / elastic recovery — the reference has no analogue; this is the
fleet-native version of the subsystem).

Long many-chain runs on shared accelerators die for reasons that have
nothing to do with the math: preemption, host OOM, a lost connection. The
driver here makes any segment-shaped sampler both

- **resumable**: the run is a deterministic schedule of segments with keys
  ``fold_in(base_key, segment)``; after every segment the carried state is
  checkpointed ATOMICALLY (tmp + rename) together with the segment index,
  and each segment's draws are persisted. A new process pointed at the
  same ``workdir`` continues exactly where the dead one stopped, and the
  assembled draws are IDENTICAL to an uninterrupted run (same keys, same
  arithmetic) — tested bit-for-bit in tests/test_resumable.py.
- **self-healing**: after each segment a health check runs (default: every
  array in the carried state AND in the segment's draws finite — the draws
  are the artifact users consume, so a segment whose state is finite but
  whose draws contain NaN is rolled back too). On failure the driver rolls
  back to the previous checkpoint and re-runs the segment with fresh
  randomness (``fold_in(base_key, segment + retry * RETRY_STRIDE)`` for
  retry >= 1 — off the main schedule by the prime stride) — the
  rollback-and-reroll recipe for transient numerical blowups; persistent
  failure (``max_retries`` exceeded) raises with the failing segment
  pinned, which is the correct behavior for a *deterministic* bug.

Works with any ``segment_fn(key, state) -> (state, draws)`` — e.g. a
jitted ``lax.scan`` of `hmc_chains` steps, a particle-filter sweep, or a
training epoch. Checkpoints use :mod:`gen_tpu.checkpoint` (npz pytrees),
so states can be traces, flat chain blocks, or optimizer stores.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..checkpoint import restore_pytree, save_pytree

RETRY_STRIDE = 1_000_003    # prime; keeps retry keys off the main schedule


def _all_finite(state, draws=None) -> bool:
    return all(bool(jnp.all(jnp.isfinite(leaf)))
               for leaf in jax.tree_util.tree_leaves((state, draws))
               if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.inexact))


def _call_health_check(health_check, state, draws) -> bool:
    """Call ``health_check(state, draws)``; single-argument checks
    (the pre-round-4 signature) keep working and see only the state.
    Arity is inspected rather than guessed from a TypeError, so a check
    that itself raises TypeError is not silently re-invoked."""
    import inspect
    try:
        params = inspect.signature(health_check).parameters
        n_required = sum(
            1 for p in params.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty)
        takes_two = (n_required >= 2
                     or any(p.kind == p.VAR_POSITIONAL
                            for p in params.values())
                     or len(params) >= 2)
    except (TypeError, ValueError):
        takes_two = True
    if takes_two:
        return bool(health_check(state, draws))
    return bool(health_check(state))


def _key_fingerprint(key) -> str:
    """Stable fingerprint of a PRNG key (schedule identity for resume
    validation)."""
    data = np.asarray(jax.random.key_data(key)).tobytes()
    import hashlib
    return hashlib.sha256(data).hexdigest()[:16]


def _state_fingerprint(state) -> str:
    """Fingerprint of the state's STRUCTURE (treedef + leaf shapes/dtypes).
    Leaf values are not hashed — the state evolves across segments; the
    structure must not."""
    import hashlib
    treedef = jax.tree_util.tree_structure(state)
    leaves = jax.tree_util.tree_leaves(state)
    desc = repr(treedef) + "|" + ";".join(
        f"{jnp.shape(l)}:{jnp.asarray(l).dtype}" for l in leaves)
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def _atomic_save(path: str, tree) -> None:
    tmp = path + ".tmp.npz"
    save_pytree(tmp, tree)
    os.replace(tmp, path)


def _meta_path(workdir):
    return os.path.join(workdir, "meta.json")


def _state_path(workdir):
    return os.path.join(workdir, "state.npz")


def _draws_path(workdir, seg):
    return os.path.join(workdir, f"draws_{seg:06d}.npz")


def resumable_run(workdir: str, key, segment_fn: Callable, state0,
                  num_segments: int,
                  health_check: Optional[Callable] = None,
                  max_retries: int = 2, verbose: bool = False):
    """Run ``num_segments`` segments of ``segment_fn``, checkpointing after
    each; resume automatically from ``workdir`` if a previous run died.

    Returns ``(state, draws, info)`` where ``draws`` is the pytree of all
    segments' draws concatenated on axis 0 and ``info`` records resumes
    and retries. Exactness contract: for a given ``(key, state0,
    segment_fn, num_segments)`` the result is identical whether or not the
    process died in between — resume only ever replays the deterministic
    key schedule. Resume validation: the base key and the state STRUCTURE
    (treedef + leaf shapes/dtypes) are fingerprinted into ``meta.json``;
    pointing a run with a different key or state0 structure at an existing
    workdir is refused rather than silently continuing the old checkpoint
    under a new schedule (``segment_fn`` itself cannot be fingerprinted —
    changing it between runs remains the caller's responsibility).

    ``health_check(state, draws) -> bool`` validates BOTH the carried
    state and the segment's draws (default: every inexact leaf finite);
    single-argument ``health_check(state)`` functions keep working.
    """
    os.makedirs(workdir, exist_ok=True)
    health_check = health_check or _all_finite
    meta_p = _meta_path(workdir)
    key_fp = _key_fingerprint(key)
    state_fp = _state_fingerprint(state0)

    start_seg, resumed = 0, False
    state = state0
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
        if meta["num_segments"] != num_segments:
            raise ValueError(
                f"workdir {workdir!r} holds a run with "
                f"{meta['num_segments']} segments; this run asked for "
                f"{num_segments} (use a fresh workdir)")
        for name, got, want in (("base key", meta.get("key_fp", key_fp),
                                 key_fp),
                                ("state0 structure",
                                 meta.get("state_fp", state_fp), state_fp)):
            if got != want:
                raise ValueError(
                    f"workdir {workdir!r} holds a run with a different "
                    f"{name} (checkpoint fingerprint {got}, this run "
                    f"{want}); resuming would silently continue the old "
                    "checkpoint under a new schedule — use a fresh workdir")
        if os.path.exists(_state_path(workdir)):
            # the segment index lives INSIDE the state checkpoint (one
            # atomic file): a crash between two separate state/meta writes
            # would otherwise let resume re-apply a segment to the
            # already-advanced state, silently breaking the bit-for-bit
            # contract
            ckpt = restore_pytree(
                _state_path(workdir),
                {"next_segment": np.asarray(0), "state": state0})
            start_seg = int(ckpt["next_segment"])
            state = ckpt["state"]
            resumed = True
            if verbose:
                print(f"[resumable] resuming at segment {start_seg}")

    retries_done = []
    draws = None
    for seg in range(start_seg, num_segments):
        for retry in range(max_retries + 1):
            k_seg = jax.random.fold_in(
                key, seg + (retry * RETRY_STRIDE if retry else 0))
            new_state, draws = segment_fn(k_seg, state)
            if _call_health_check(health_check, new_state, draws):
                break
            if verbose:
                print(f"[resumable] segment {seg} failed health check "
                      f"(retry {retry}) — rolling back with fresh "
                      "randomness")
            retries_done.append((seg, retry))
        else:
            raise RuntimeError(
                f"segment {seg} failed its health check {max_retries + 1} "
                "times — deterministic failure; inspect "
                f"{_state_path(workdir)}")
        state = new_state
        # draws first (deterministic: a crash before the state checkpoint
        # re-runs the segment and rewrites identical draws), then the
        # single atomic state+index checkpoint
        _atomic_save(_draws_path(workdir, seg), draws)
        _atomic_save(_state_path(workdir),
                     {"next_segment": np.asarray(seg + 1), "state": state})
        with open(meta_p + ".tmp", "w") as f:
            json.dump({"num_segments": num_segments, "key_fp": key_fp,
                       "state_fp": state_fp}, f)
        os.replace(meta_p + ".tmp", meta_p)

    # assemble all segments' draws (template from the last one)
    draws_tmpl = draws
    if draws_tmpl is None:      # fully-resumed no-op run: load one
        draws_tmpl = _load_draws(workdir, num_segments - 1, None)
    per_seg = [_load_draws(workdir, s, draws_tmpl)
               for s in range(num_segments)]
    all_draws = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *per_seg)
    info = dict(resumed=resumed, start_segment=start_seg,
                retries=retries_done)
    return state, all_draws, info


def _load_draws(workdir, seg, template):
    path = _draws_path(workdir, seg)
    if template is None:
        # structure-free single-array or dict loads need a template; for
        # the no-op-resume path rebuild from the file itself
        with np.load(path, allow_pickle=True) as data:
            keys = list(data["__keys__"])
            leaves = [jnp.asarray(data[f"leaf_{i}"])
                      for i in range(len(keys))]
        if keys == ["__root__"]:
            return leaves[0]
        raise ValueError(
            "resuming a fully-completed run with structured draws needs "
            "the same segment_fn to rebuild the template; run with at "
            "least one remaining segment or keep draws as a single array")
    return restore_pytree(path, template)
