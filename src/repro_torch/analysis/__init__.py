"""Static and runtime checks of the port's hot-path invariants.

* ``repro_torch.analysis.lint``: an AST linter over ``src/repro_torch``
  with the rules that have a PyTorch meaning: R2 (no host sync in the
  step's device-side bodies), R4 (every kernel wrapper counted and backed
  by a plain body), R5 (no unseeded entropy in ``serving/``)
  (``python -m repro_torch.analysis.lint src/repro_torch``).
* ``repro_torch.analysis.trace_contract``: the MoE block's collectives,
  counted on the ranks of a mesh, against ``cost_model.comm_census``, and
  the synchronizing calls a function makes on the card
  (``python -m repro_torch.analysis.trace_contract``).
"""

# Submodules import lazily so `python -m repro_torch.analysis.lint` does not
# re-import the module it is executing (runpy double-import warning).
__all__ = ["Finding", "lint_paths", "lint_sources"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(name)
