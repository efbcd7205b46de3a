"""R5: no nondeterminism in serving/ outside faults.py."""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.astutils import normalized
from repro_torch.analysis.lint import Finding

# wall-clock entropy (time.perf_counter/monotonic/sleep are exempt:
# monotonic metrics timestamps and pacing, not decision entropy)
_CLOCK_FNS = {"time.time", "time.time_ns"}
# the stdlib global-state RNG and numpy's legacy global RNG
_GLOBAL_RNG_PREFIXES = ("random.",)
_NP_LEGACY = {"np.random." + f for f in
              ("rand", "randn", "randint", "random", "choice", "shuffle",
               "permutation", "seed", "uniform", "normal", "poisson",
               "exponential")}
# torch's draws: from the global generator unless given ``generator=``
_TORCH_DRAWS = {"torch." + f for f in
                ("rand", "randn", "randint", "randperm", "multinomial",
                 "bernoulli", "normal", "rand_like", "randn_like",
                 "randint_like", "poisson")}
_TENSOR_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                 "bernoulli_", "geometric_", "cauchy_", "log_normal_"}
# calls that reseed torch's global generator
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "torch.cuda.seed",
                "torch.random.manual_seed", "torch.random.seed"}
_EXEMPT_FILES = ("faults.py",)


def _entropy(node: ast.AST, mod) -> bool:
    """True when a seed expression itself calls a clock or an RNG."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = normalized(mod, sub.func) or ""
        if name in _CLOCK_FNS or name.startswith(_GLOBAL_RNG_PREFIXES) \
                or name in _NP_LEGACY or name in _TORCH_DRAWS \
                or name in ("torch.seed", "torch.initial_seed"):
            return True
    return False


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


class ServingDeterminismRule:
    """No nondeterminism in ``serving/`` outside ``faults.py`` and metrics
    timestamps.

    Determinism is what makes fault replay and the stream-parity tests
    meaningful: a serving trace (admissions, preemptions, speculation
    accept/reject, chaos schedules, sampled tokens) must replay identically
    from a seed.  One ``time.time()``-seeded decision or global-RNG draw
    anywhere in the scheduler or engine breaks that, passes every
    functional test, and shows up only as an incident no one can replay.

    Flags, in ``serving/`` files other than ``faults.py`` (the fault
    injector owns its seeded entropy): ``time.time`` / ``time_ns``, stdlib
    ``random.*``, numpy's legacy global RNG, ``np.random.default_rng()``
    with no seed; torch's draws from its global generator (``torch.rand``,
    ``randn``, ``randint``, ``randperm``, ``multinomial``, ``bernoulli``,
    ``normal`` and the ``*_like`` forms without ``generator=``, and the
    in-place ``Tensor.uniform_`` / ``normal_`` / ``exponential_`` /
    ``random_`` ... without ``generator=``); ``torch.manual_seed`` /
    ``torch.seed`` (a reseed of the global generator from serving code);
    and ``torch.Generator(...).manual_seed(...)`` seeded from a clock or an
    RNG.  ``np.random.default_rng(seed)`` and a ``torch.Generator`` seeded
    from the spec stay legal, as do ``time.perf_counter`` /
    ``monotonic`` / ``sleep``.
    """

    id = "R5"
    title = "no nondeterminism in serving/ outside faults.py"

    def _applies(self, mod) -> bool:
        # fixture modules named fixture_*_r5 count as serving/ files so the
        # self-test exercises the rule without a src tree
        if mod.name.startswith("fixture_") and mod.name.endswith("_r5"):
            return True
        return "serving" in mod.name.split(".") \
            and mod.path.name not in _EXEMPT_FILES

    def _fault(self, node: ast.Call, mod) -> Optional[str]:
        name = normalized(mod, node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if name in _CLOCK_FNS:
            return (f"`{name}()` in serving/: wall-clock entropy breaks "
                    "fault replay; use time.perf_counter for metrics "
                    "timestamps or a seeded generator for decisions")
        if name and name.startswith(_GLOBAL_RNG_PREFIXES):
            return (f"`{name}` in serving/: the stdlib global RNG is "
                    "unseeded shared state; use np.random.default_rng(seed)")
        if name in _NP_LEGACY:
            return (f"`{name}` in serving/: numpy's legacy global RNG; use "
                    "np.random.default_rng(seed)")
        if name == "np.random.default_rng" and not node.args \
                and not node.keywords:
            return ("`np.random.default_rng()` without a seed in serving/: "
                    "draws differ from run to run")
        if name in _TORCH_DRAWS and not _has_generator(node):
            return (f"`{name}` without generator= in serving/: a draw from "
                    "torch's global generator; pass a torch.Generator "
                    "seeded from the spec")
        if name in _TORCH_SEEDS:
            return (f"`{name}` in serving/: reseeds torch's global "
                    "generator under every other user of it; seed a "
                    "torch.Generator of the engine's own")
        if attr in _TENSOR_DRAWS and not _has_generator(node):
            return (f"`.{attr}()` without generator= in serving/: an "
                    "in-place draw from torch's global generator")
        if attr == "manual_seed" and node.args \
                and _entropy(node.args[0], mod):
            return ("a generator's `manual_seed` from a clock or an RNG in "
                    "serving/: the seed must derive from the spec")
        return None

    def check(self, ctx) -> Iterable[Finding]:
        for mod in ctx.modules:
            if not self._applies(mod):
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    msg = self._fault(node, mod)
                    if msg:
                        yield Finding(self.id, str(mod.path), node.lineno,
                                      node.col_offset, msg)

    FIXTURE_BAD = '''
import time
import random
import numpy as np
import torch


def admit(queue):
    if random.random() < 0.5:            # global RNG decision
        return queue.pop()
    return None


def stamp():
    return time.time()                   # wall clock, not perf_counter


def make_rng():
    return np.random.default_rng()       # unseeded


def sample(probs, x):
    torch.manual_seed(0)                 # reseeds the global generator
    noise = torch.randn(4)               # global generator
    x.uniform_()                         # in-place global draw
    gen = torch.Generator().manual_seed(int(time.time()))   # clock seed
    return torch.multinomial(probs, 1), noise, gen
'''

    FIXTURE_GOOD = '''
import time
import numpy as np
import torch


def admit(queue, rng):
    if rng.random() < 0.5:               # caller-provided seeded rng
        return queue.pop()
    return None


def stamp():
    return time.perf_counter()           # monotonic metrics timestamp


def make_rng(seed):
    return np.random.default_rng(seed)


def sample(probs, x, seed):
    gen = torch.Generator().manual_seed(seed)
    x.uniform_(generator=gen)
    noise = torch.randn(4, generator=gen)
    return torch.multinomial(probs, 1, generator=gen), noise
'''


RULE = ServingDeterminismRule()
