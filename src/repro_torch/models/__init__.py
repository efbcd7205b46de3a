"""The decoder: parameter declarations, layers, MoE block, forward."""
