"""The claim layer the port's fabric runs on by default.

The serving fabric grows and shrinks its replica set through
ResourceClaims: the :class:`~tpu_dra_torch.serving.autoscaler.ClaimAutoscaler`
calls ``create``, ``try_get`` and ``delete`` on a claim client, and a
replica binds once a claim carries ``status.allocation``. In the driver
a scheduler places the claims on a fleet of nodes; one card has no
fleet, so :class:`ClaimStore` grants every claim at once, on the card
the engines run on.

:class:`~tpu_dra_torch.serving.fabricbench.Fabric` takes its claim
layer as a parameter (an object with ``claims``, ``start()`` and
``stop()``): a :class:`ClaimStore` by default, or any layer whose
``claims`` has the same calls — a real scheduler's, as the CPU twin
tests inject.

:func:`make_claim` is a copy of ``tpu_dra/scheduler/fleet.py``'s (the
port imports nothing of the JAX package), so both packages write the
same claim object.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Tuple

DRIVER = "tpu.google.com"
# The DeviceClass a sub-slice claim names (the driver's SUBSLICE_CLASS).
SUBSLICE_CLASS_NAME = "tpu-subslice.google.com"


def make_claim(
    i: int,
    shape: str,
    gen: Optional[str] = None,
    namespace: str = "allocbench",
) -> dict:
    """A ResourceClaim for one sub-slice of ``shape`` (``"1x1x1"``,
    ``"2x2x1"``, ...), optionally pinned to a TPU generation."""
    selectors = [{"cel": {"expression":
        f"device.attributes['{DRIVER}'].subsliceShape == "
        f"'{shape}'"}}]
    if gen is not None:
        selectors.append({"cel": {"expression":
            f"device.attributes['{DRIVER}'].generation == "
            f"'{gen}'"}})
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceClaim",
        "metadata": {
            "name": f"claim-{i:05d}",
            "namespace": namespace,
            "uid": f"uid-{i:05d}",
        },
        "spec": {"devices": {"requests": [{
            "name": "tpu",
            "deviceClassName": SUBSLICE_CLASS_NAME,
            "selectors": selectors,
        }]}},
    }


class ClaimStore:
    """An in-process claim store that allocates every claim as it is
    created: ``status.allocation.devices.results`` becomes
    ``[{"pool": NODE, "device": device}]`` (the one card the engines
    run on). Thread-safe; objects go in and come out as copies, as
    through an API server. A claim without a namespace lands in
    NAMESPACE, the autoscaler's. ``log`` holds ``("created" |
    "deleted", name)`` in the order they happened.

    It is also a claim layer: ``claims`` is the store itself, and
    ``start`` and ``stop`` do nothing."""

    NODE = "card-0"
    NAMESPACE = "fabric"

    def __init__(self, device: str = "cpu"):
        self.device = device
        self._lock = threading.Lock()
        self._store: Dict[Tuple[str, str], dict] = {}
        self.log: List[Tuple[str, str]] = []

    # --- the claim layer ---

    @property
    def claims(self) -> "ClaimStore":
        return self

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    # --- the claim client ---

    def _key(self, name: str, namespace: Optional[str]) -> tuple:
        return (namespace or self.NAMESPACE, name)

    def create(self, obj: dict) -> dict:
        meta = obj.setdefault("metadata", {})
        key = self._key(meta["name"], meta.get("namespace"))
        out = copy.deepcopy(obj)
        out.setdefault("status", {})["allocation"] = {"devices": {
            "results": [{"pool": self.NODE, "device": self.device}]}}
        with self._lock:
            if key in self._store:
                raise ValueError(f"claim {key[0]}/{key[1]} already exists")
            self._store[key] = out
            self.log.append(("created", key[1]))
        return copy.deepcopy(out)

    def try_get(self, name: str, namespace: Optional[str] = None):
        with self._lock:
            obj = self._store.get(self._key(name, namespace))
            return copy.deepcopy(obj) if obj is not None else None

    def delete(self, name: str, namespace: Optional[str] = None) -> None:
        key = self._key(name, namespace)
        with self._lock:
            if self._store.pop(key, None) is None:
                raise KeyError(f"claim {key[0]}/{key[1]} not found")
            self.log.append(("deleted", key[1]))

    def list(self, namespace: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [copy.deepcopy(v) for (ns, _), v in
                    sorted(self._store.items())
                    if namespace is None or ns == namespace]

    @property
    def deleted(self) -> List[str]:
        """The names deleted, in order."""
        with self._lock:
            return [name for op, name in self.log if op == "deleted"]
