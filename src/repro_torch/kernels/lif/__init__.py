"""Fused LIF neuron update: plain torch version, wrapper and Triton kernel."""
