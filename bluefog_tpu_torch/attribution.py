# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Structured diagnoses: the ``Advisory`` record of the JAX package's
``bluefog_tpu.attribution``, which the asynchronous gossip engine files
when its staleness gate acts (:mod:`bluefog_tpu_torch.async_gossip`); the
engine counts it in ``bluefog.doctor.advisory.<kind>`` and notes it in the
flight recorder and the timeline.

The step-time attribution observatory itself (the doctor's sampling,
probes and blame) waits for ROADMAP A13b."""

import dataclasses
from typing import Any, Dict

__all__ = ["Advisory"]


@dataclasses.dataclass(frozen=True)
class Advisory:
    """One structured diagnosis; ``detail`` is JSON-serializable."""

    kind: str
    step: int
    detail: Dict[str, Any]

    def to_json(self) -> dict:
        return {"kind": self.kind, "step": self.step, **self.detail}
