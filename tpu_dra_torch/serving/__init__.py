"""Serving fabric: the tier above one engine.

The port's own copy of ``tpu_dra/serving/`` (its Router, fault
machinery and claim autoscaler; the port imports nothing of the JAX
package), driving the port's :class:`~tpu_dra_torch.workloads.engine.Engine`
through the calls the JAX tier makes of its engine.

- :mod:`tpu_dra_torch.serving.router` — session/prefix-affinity-aware
  dispatch, per-tenant SLO classes (latency-tier admission control),
  weighted fair queuing over *tokens*, disaggregated prefill→decode
  with live KV migration, and crash recovery (dispatch journal,
  circuit breaker, stuck-step watchdog);
- :mod:`tpu_dra_torch.serving.faults` — the journal, the breaker and
  the re-dispatch backoff;
- :mod:`tpu_dra_torch.serving.autoscaler` — claim-driven autoscaling:
  the replica set grows by CREATING ResourceClaims and shrinks by
  evacuating an engine BEFORE its ResourceClaim is deleted;
- :mod:`tpu_dra_torch.serving.claims` — the claim layer the fabric runs
  on by default (:class:`ClaimStore`, which allocates every claim at
  once) and :func:`make_claim`;
- :mod:`tpu_dra_torch.serving.repack` — the serving half of a repacker
  migration (:class:`FabricRepackAdapter`);
- :mod:`tpu_dra_torch.serving.fabricbench`,
  :mod:`~tpu_dra_torch.serving.faultbench` and
  :mod:`~tpu_dra_torch.serving.disaggbench` — the tier's benches and
  drills: TTFT per tenant, WFQ fairness, claim-driven scale-up and
  lossless scale-down; crash, stall and crash-loop recovery; the
  prefill→decode handoff and colocated against disaggregated latency.
"""

from tpu_dra_torch.serving.router import (  # noqa: F401
    BATCH,
    INTERACTIVE,
    STANDARD,
    FabricCompletion,
    Replica,
    Router,
    RouterConfig,
    SLOClass,
    TenantSpec,
)
from tpu_dra_torch.serving.autoscaler import (  # noqa: F401
    AutoscalerConfig,
    ClaimAutoscaler,
)
from tpu_dra_torch.serving.claims import (  # noqa: F401
    ClaimStore,
    make_claim,
)
from tpu_dra_torch.serving.repack import (  # noqa: F401
    FabricRepackAdapter,
    ServingAdapter,
)
