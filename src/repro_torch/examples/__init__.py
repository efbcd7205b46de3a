"""Runnable examples of the port's public API; each is a module with a
``main(argv=None)``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.serve_moe
  PYTHONPATH=src python -m repro_torch.examples.autotune_strategy
  PYTHONPATH=src python -m repro_torch.examples.train_small

Each runs on CUDA unless ``--device cpu`` is given.
"""
