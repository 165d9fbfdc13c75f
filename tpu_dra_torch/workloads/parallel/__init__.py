"""Parallel layouts of the port over a torch.distributed group: the
training mesh and the (batch x model) decode mesh (mesh.py), the global
mesh context (context.py), ring attention (ring_attention.py), Ulysses
attention (ulysses.py) and the pipeline relay over pp (pipeline.py),
whose functions the package exports."""

from tpu_dra_torch.workloads.parallel.pipeline import (  # noqa: F401
    partition_stages,
    pipeline_apply,
    pipelined_llama_forward,
    stage_layer_names,
)
