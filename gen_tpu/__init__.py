"""gen_tpu: a accelerator-native probabilistic programming framework with
programmable inference.

A from-scratch JAX/XLA rebuild of the capabilities of Gen.jl
(/root/reference — MIT ProbComp, PLDI '19): generative functions with the
full GFI (simulate / generate / assess / propose / project / update /
regenerate / choice_gradients / param_gradients), hierarchical choice maps
and selections, combinators (Map=vmap, Unfold=scan, Switch, Mixtures), and a
programmable inference library (IS, MH, involutive MCMC, HMC/MALA/NUTS,
SMC/PMMH, BBVI/VIMCO, amortized training) that vectorizes over chains and
particles with ``vmap`` and shards over device meshes with ``pjit``/collectives.
"""

from .address import Address
from .choice_map import ChoiceMap, choicemap
from .selection import (Selection, AllSelection, EmptySelection,
                        HierarchicalSelection, ComplementSelection,
                        select, selectall, selectnone, complement, ALL, NONE)
from .diff import (Diff, NoChange, UnknownChange, IntDiff, VectorDiff,
                   Diffed, all_no_change, all_unknown_change)
from .gfi import GenerativeFunction, Trace
from .dists import *  # noqa: F401,F403
from .dists import __all__ as _dists_all
from .dynamic import (GenFn, gen, param, trace_at, init_param, get_param,
                      set_param, get_param_grad, zero_param_grad,
                      set_param_grad, DynamicTrace)
from .combinators import (Map, MapCombinator, Unfold, UnfoldCombinator,
                          choice_at, call_at, VectorChoiceMap,
                          vector_choicemap, Switch, SwitchCombinator, Recurse,
                          RecurseLeveled,
                          CustomDetermGF, CustomUpdateGF, CustomGradientGF,
                          UnfoldArena, smc_run)
from .masked import MaskedValue, mask, MaskedSelection, masked_select
from . import diagnostics
from . import inference
from . import learning
from . import static_ir
from . import models
from .utils import logsumexp

__version__ = "0.1.0"

__all__ = [
    "Address", "ChoiceMap", "choicemap",
    "Selection", "AllSelection", "EmptySelection", "HierarchicalSelection",
    "ComplementSelection", "select", "selectall", "selectnone", "complement",
    "ALL", "NONE",
    "Diff", "NoChange", "UnknownChange", "IntDiff", "VectorDiff", "Diffed",
    "all_no_change", "all_unknown_change",
    "GenerativeFunction", "Trace",
    "GenFn", "gen", "param", "trace_at", "init_param", "get_param",
    "set_param", "get_param_grad", "zero_param_grad", "set_param_grad",
    "DynamicTrace", "logsumexp",
    "Map", "MapCombinator", "Unfold", "UnfoldCombinator", "choice_at",
    "call_at", "VectorChoiceMap", "vector_choicemap", "inference",
    "Switch", "SwitchCombinator", "Recurse", "RecurseLeveled", "CustomDetermGF", "CustomUpdateGF",
    "CustomGradientGF", "UnfoldArena", "smc_run", "MaskedValue", "mask",
    "MaskedSelection", "masked_select",
    "learning", "static_ir", "diagnostics",
] + _dists_all
