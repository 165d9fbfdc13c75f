"""Parallel layouts of the port over a torch.distributed group: the
training mesh and the (batch x model) decode mesh (mesh.py), the global
mesh context (context.py), ring attention (ring_attention.py) and
Ulysses attention (ulysses.py)."""
