"""Multi-rank execution on torch.distributed (the mpirun -n analogue)."""
