"""Parallel layouts of the port: the (batch x model) decode mesh over a
torch.distributed group (mesh.py)."""
