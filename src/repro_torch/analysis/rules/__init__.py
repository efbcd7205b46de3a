"""The port's lint rules.

Each rule module exports a ``RULE`` instance with:

* ``id`` / ``title``: the stable identifier (the JAX package's number) and
  a one-line summary,
* a class docstring carrying the rationale,
* ``check(ctx)`` yielding ``Finding``s,
* ``FIXTURE_BAD`` / ``FIXTURE_GOOD``: the seeded-violation and clean
  snippets used by ``--self-test`` and ``tests/test_torch_analysis.py``.

R1 (a sort inside ``shard_map``) and R3 (a Python branch on a traced value)
are about XLA tracing; eager PyTorch has neither, so they have no rule here.

Suppression: ``# repro-lint: disable=<ID>`` on the flagged line or the
line above, with a justification comment.
"""

from repro_torch.analysis.rules.r2_host_sync import RULE as R2
from repro_torch.analysis.rules.r4_kernel_contract import RULE as R4
from repro_torch.analysis.rules.r5_serving_determinism import RULE as R5

RULES = (R2, R4, R5)

__all__ = ["RULES", "R2", "R4", "R5"]
