"""Goal inference over a deterministic path planner: the planner is a
CustomDetermGF node inside the agent model, and SMC infers the agent's
destination from noisy position observations.

Reference: /root/reference/examples/planning/path_planner.jl:1-343 (RRT +
stochastic path refinement), model.jl:1-82 (start/goal/speed/noise latents,
plan_path deterministic node, walk at constant speed, noisy per-step
observations) and filtering.jl:1-120 (the distance-along-path HMM with
slack, filtered with SMC).

accelerator-native planner design: the reference's RRT is a pointer-chasing
sequential search (nearest-neighbor loops, data-dependent tree growth) —
the worst possible shape for XLA. The same planning problem solves as a
DENSE DYNAMIC PROGRAM: a value-iteration distance field from the goal over
a G x G occupancy grid (fixed-trip-count ``lax.scan`` of 8-neighbor
min-plus relaxations — pure elementwise/shift ops) followed by fixed-length
greedy descent for path extraction (one-hot plane reads, no gathers — the
dynamic-index-under-vmap trap documented in ops/resample.py). Every step is
branchless and fixed-shape, so the planner vmaps over thousands of particle
hypotheses — the reference plans ONE path per trace; here planning IS the
vmapped hot loop.

The planner is wrapped as a :class:`gen_tpu.combinators.CustomDetermGF`
(reference src/modeling_library/custom_determ.jl:1-207): zero score, empty
choices, and a custom ``update_with_state`` that reuses the cached distance
field + path when the argdiffs say the goal did not change — the
incremental-computation contract the reference defines (and, notably, its
own planning example does not use: model.jl calls plan_path as a bare Julia
function that re-runs on every update).

Run: python examples/planning.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import ChoiceMap, choicemap, gen
from gen_tpu.combinators import CustomDetermGF, UnfoldCombinator
from gen_tpu.diff import NoChange, UnknownChange
from gen_tpu.inference import (ParticleFilterState, effective_sample_size,
                               initialize_particle_filter, maybe_resample,
                               particle_filter_step)

G = 24                 # grid resolution
VI_ITERS = 2 * G       # value-iteration sweeps (enough for full propagation)
T_PATH = 40            # greedy-descent path length (waypoints)
START = (0.1, 0.1)
DT = 0.1
DIST_SLACK = 0.03      # distance-along-path HMM slack (filtering.jl)

# scene: a vertical wall at x ~ 0.5 with a gap near the top — goals on the
# right require a detour through the gap (reference scenes.jl walls)
_ii, _jj = np.meshgrid(np.arange(G), np.arange(G), indexing="ij")
_cx, _cy = (_ii + 0.5) / G, (_jj + 0.5) / G
OCCUPANCY = jnp.asarray((np.abs(_cx - 0.5) < 0.04) & (_cy < 0.72))

_NBR = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
        if (dx, dy) != (0, 0)]
_NBR_COST = [float(np.hypot(dx, dy)) / G for dx, dy in _NBR]


def _shift(field, dx, dy, fill):
    """field shifted so that out[i,j] = field[i-dx, j-dy] (edges -> fill)."""
    out = jnp.roll(field, (dx, dy), axis=(0, 1))
    if dx == 1:
        out = out.at[0, :].set(fill)
    elif dx == -1:
        out = out.at[-1, :].set(fill)
    if dy == 1:
        out = out.at[:, 0].set(fill)
    elif dy == -1:
        out = out.at[:, -1].set(fill)
    return out


def distance_field(occ, goal_xy):
    """Value iteration: D[i,j] ~ cost-to-go to the goal cell avoiding
    obstacles. Obstacle cells cost a large finite penalty (not inf) so the
    field and every downstream quantity stay finite for any traced goal."""
    big = jnp.asarray(1e3, jnp.float32)
    gi = jnp.clip((goal_xy[0] * G).astype(jnp.int32), 0, G - 1)
    gj = jnp.clip((goal_xy[1] * G).astype(jnp.int32), 0, G - 1)
    goal_onehot = ((jax.lax.broadcasted_iota(jnp.int32, (G, G), 0) == gi)
                   & (jax.lax.broadcasted_iota(jnp.int32, (G, G), 1) == gj))
    enter_cost = jnp.where(occ, big, 0.0)
    d0 = jnp.where(goal_onehot, 0.0, 1e6).astype(jnp.float32)

    def sweep(d, _):
        best = d
        for (dx, dy), c in zip(_NBR, _NBR_COST):
            cand = _shift(d, dx, dy, 1e6) + c + enter_cost
            best = jnp.minimum(best, cand)
        return jnp.where(goal_onehot, 0.0, best), None

    d, _ = jax.lax.scan(sweep, d0, None, length=VI_ITERS)
    return d


def greedy_path(field, start_xy):
    """T_PATH waypoints of steepest descent on the field, one-hot plane
    reads only (dynamic gathers under vmap were the slow path on the
    accelerator this was first written for)."""
    si = jnp.clip((start_xy[0] * G).astype(jnp.int32), 0, G - 1)
    sj = jnp.clip((start_xy[1] * G).astype(jnp.int32), 0, G - 1)
    ii = jax.lax.broadcasted_iota(jnp.int32, (G, G), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (G, G), 1)

    def read(i, j):
        onehot = (ii == i) & (jj == j)
        return jnp.sum(jnp.where(onehot, field, 0.0))

    def step(pos, _):
        i, j = pos
        # on a CONVERGED field the best neighbor satisfies
        # D(n) + c == D(center) exactly (Bellman equality), so strict
        # descent never moves: accept equality up to a tolerance. At the
        # goal (D=0) every neighbor costs +c > tol, so the walk stays put.
        here = read(i, j)
        best_v = here + 1e-4
        best = (i, j)
        for (dx, dy), c in zip(_NBR, _NBR_COST):
            ni = jnp.clip(i + dx, 0, G - 1)
            nj = jnp.clip(j + dy, 0, G - 1)
            v = read(ni, nj) + c
            take = v < best_v
            best = (jnp.where(take, ni, best[0]),
                    jnp.where(take, nj, best[1]))
            best_v = jnp.minimum(best_v, v)
        return best, jnp.stack([(best[0] + 0.5) / G, (best[1] + 0.5) / G])

    _, pts = jax.lax.scan(step, (si, sj), None, length=T_PATH)
    start_pt = jnp.stack([(si + 0.5) / G, (sj + 0.5) / G])
    pts = jnp.concatenate([start_pt[None], pts], axis=0)  # (T_PATH+1, 2)
    seg = jnp.linalg.norm(pts[1:] - pts[:-1], axis=1)
    cumdist = jnp.concatenate([jnp.zeros(1), jnp.cumsum(seg)])
    return pts, cumdist


def walk_path(pts, cumdist, d):
    """Location after walking distance ``d`` along the waypoints — the
    branchless form of the reference's walk_path (path_planner.jl:278-343):
    per-segment interpolation weights, no searchsorted/gather."""
    d = jnp.clip(d, 0.0, cumdist[-1])
    lo, hi = cumdist[:-1], cumdist[1:]
    frac = jnp.clip((d - lo) / jnp.maximum(hi - lo, 1e-9), 0.0, 1.0)
    seg_pts = pts[:-1] + frac[:, None] * (pts[1:] - pts[:-1])
    in_seg = (d >= lo) & (d < hi)
    # exactly one segment matches (or none when d == total: use the end)
    any_seg = jnp.any(in_seg)
    w = in_seg.astype(pts.dtype)
    loc = jnp.sum(w[:, None] * seg_pts, axis=0)
    return jnp.where(any_seg, loc, pts[-1])


class PlanPath(CustomDetermGF):
    """plan_path(goal_x, goal_y) -> (waypoints, cumdist) as a deterministic
    generative function with incremental state: when ``update`` is told the
    goal is unchanged (NoChange argdiffs), the cached field/path is reused
    and no value iteration runs (reference custom_determ.jl:10-63 contract).
    Non-differentiable (min-plus dynamic program), like the reference's RRT:
    has_argument_grads is all-False."""

    def __init__(self, occupancy):
        self.occupancy = occupancy
        self.apply_count = 0     # host-side instrumentation (trace-time)

    def has_argument_grads(self):
        return (False, False)

    def apply_with_state(self, args):
        self.apply_count += 1
        gx, gy = args
        field = distance_field(self.occupancy, (gx, gy))
        pts, cumdist = greedy_path(field, jnp.asarray(START))
        retval = (pts, cumdist)
        return retval, retval

    def update_with_state(self, state, args, argdiffs):
        if all(d is NoChange for d in argdiffs):
            return state, state, NoChange
        retval, new_state = self.apply_with_state(args)
        return new_state, retval, UnknownChange


plan_path = PlanPath(OCCUPANCY)


# -- agent model (reference model.jl + filtering.jl's dist-slack HMM) --------

@gen
def walk_kernel(t, dist_prev, pts, cumdist, speed, noise):
    dist = gt.normal(dist_prev + speed * DT, DIST_SLACK) @ "dist"
    loc = walk_path(pts, cumdist, dist)
    gt.normal(loc[0], noise) @ "x"
    gt.normal(loc[1], noise) @ "y"
    return dist


walk_hmm = UnfoldCombinator(walk_kernel)


@gen
def agent_model(T):
    goal_x = gt.uniform(0.0, 1.0) @ "goal_x"
    goal_y = gt.uniform(0.0, 1.0) @ "goal_y"
    speed = gt.uniform(0.0, 1.0) @ "speed"
    noise = 0.02 + 0.1 * (gt.uniform(0.0, 1.0) @ "noise")
    pts, cumdist = plan_path(goal_x, goal_y) @ "plan"
    walk_hmm(T, jnp.asarray(0.0), pts, cumdist, speed, noise) @ "steps"
    return (goal_x, goal_y)


# -- data ---------------------------------------------------------------------

def simulate_observations(T, goal, speed=0.45, noise=0.04, seed=0):
    """Agent walks the planned path to ``goal``; return (T, 2) noisy obs."""
    rng = np.random.default_rng(seed)
    field = distance_field(OCCUPANCY, (jnp.asarray(goal[0]),
                                       jnp.asarray(goal[1])))
    pts, cumdist = greedy_path(field, jnp.asarray(START))
    obs = []
    d = 0.0
    for t in range(T):
        d = d + speed * DT + DIST_SLACK * rng.standard_normal()
        loc = np.asarray(walk_path(pts, cumdist, jnp.asarray(d)))
        obs.append(loc + noise * rng.standard_normal(2))
    return np.asarray(obs)


# -- SMC goal inference --------------------------------------------------------

def goal_posterior(state: ParticleFilterState):
    w = np.asarray(jax.nn.softmax(state.log_weights))
    gx = np.asarray(state.traces.get_choices()["goal_x"])
    gy = np.asarray(state.traces.get_choices()["goal_y"])
    mean = np.array([np.sum(w * gx), np.sum(w * gy)])
    sd = np.sqrt(np.array([np.sum(w * (gx - mean[0]) ** 2),
                           np.sum(w * (gy - mean[1]) ** 2)]))
    return mean, sd


def run_smc(key, obs_path, n_particles=1024):
    """Reference particle-filter pattern (particle_filter.jl:99-213): init
    with the first observation, then extend one step at a time via update
    with the next observation constrained. Each extension re-plans per
    particle only because the dynamic DSL passes UnknownChange to sub-calls
    (matching the reference's dynamic DSL); the one-program arena variant in
    examples/smc_planning.py avoids even that."""
    T = obs_path.shape[0]

    def obs_at(t):
        return ChoiceMap().set_submap(
            ("steps", t), ChoiceMap.from_dict(
                {"x": jnp.asarray(obs_path[t, 0]),
                 "y": jnp.asarray(obs_path[t, 1])}))

    key, k0 = jax.random.split(key)
    state = initialize_particle_filter(k0, agent_model, (1,), obs_at(0),
                                       n_particles)
    history = [goal_posterior(state)]
    for t in range(1, T):
        key, k_res, k_ext = jax.random.split(key, 3)
        state, _ = maybe_resample(k_res, state, ess_threshold=n_particles / 2)
        state = particle_filter_step(k_ext, state, (t + 1,),
                                     (UnknownChange,), obs_at(t))
        history.append(goal_posterior(state))
    return state, history


def demo_custom_update_state():
    """The CustomDetermGF contract at the GFI level: NoChange argdiffs reuse
    the cached plan (no value iteration); a changed goal recomputes."""
    tr = plan_path.simulate(None, (jnp.asarray(0.8), jnp.asarray(0.9)))
    n0 = plan_path.apply_count
    tr2, w, retdiff, _ = plan_path.update(
        None, tr, tr.get_args(), (NoChange, NoChange), ChoiceMap())
    assert plan_path.apply_count == n0, "NoChange update must reuse the plan"
    assert retdiff is NoChange
    assert tr2.get_retval() is tr.get_retval()
    tr3, _, retdiff3, _ = plan_path.update(
        None, tr, (jnp.asarray(0.2), jnp.asarray(0.9)),
        (UnknownChange, NoChange), ChoiceMap())
    assert plan_path.apply_count == n0 + 1, "changed goal must re-plan"
    print("CustomDetermGF update-state contract OK "
          f"(cached reuse on NoChange; {plan_path.apply_count} plans)")


def main(T=14, n_particles=1024, seed=0):
    demo_custom_update_state()

    true_goal = (0.85, 0.25)     # behind the wall: the path must detour
    obs_path = simulate_observations(T, true_goal, seed=seed)

    state, history = run_smc(jax.random.PRNGKey(seed), obs_path, n_particles)
    for t in (1, 4, T - 1):
        mean, sd = history[t]
        print(f"after {t + 1:2d} obs: goal mean=({mean[0]:.3f}, "
              f"{mean[1]:.3f}) sd=({sd[0]:.3f}, {sd[1]:.3f})")
    mean_f, sd_f = history[-1]
    _, sd_0 = history[1]
    err = float(np.linalg.norm(mean_f - np.asarray(true_goal)))
    print(f"true goal: {true_goal}; final posterior-mean error: {err:.3f}")
    assert err < 0.15, (mean_f, true_goal)
    # the posterior must SHARPEN as observations accumulate
    assert np.all(sd_f < sd_0), (sd_f, sd_0)
    print("planning example OK: posterior over destinations sharpens "
          "and the planner is a CustomDetermGF with cached update state")


if __name__ == "__main__":
    main()
