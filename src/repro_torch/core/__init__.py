"""Network substrate of the port: N:M sparsity, WU gating, the timestep
engine and the SNN state layouts (counterpart of ``repro.core``)."""
