"""Offline stage: topology, cost model, analyzer, knob resolution, plan."""
