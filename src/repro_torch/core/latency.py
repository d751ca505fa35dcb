"""The latency terms the port's runtime prices with.

A partial copy of ``repro.core.latency`` (pure analytic modelling, no
JAX): the per-tier KV recall costs that ``runtime.kvcache``'s cost-model
eviction minimizes (``TierRecallCosts``, ``kv_recall_costs``), their
cross-check against a measured fetch timeline
(``tier_recall_crosscheck``, ``StreamingCheck``, ``median_event_duration``,
``aggregate_bps``), and the speculative decoder's
``expected_tokens_per_cycle``. The token-latency model, the Halda
objective and the device profiles are not copied yet (ROADMAP Queue A
item 5); where the JAX function takes a ``DeviceProfile``, this one takes
any object with ``cpu_membw`` and ``disk_speed()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def expected_tokens_per_cycle(acceptance: float, gamma: int) -> float:
    """E[tokens emitted per draft/verify cycle] at per-draft acceptance
    rate a: sum_{j<g} (j+1) a^j (1-a) + (g+1) a^g = (1 - a^{g+1})/(1 - a).
    """
    if acceptance >= 1.0:
        return gamma + 1.0
    if acceptance <= 0.0:
        return 1.0
    return (1.0 - acceptance ** (gamma + 1)) / (1.0 - acceptance)


@dataclasses.dataclass(frozen=True)
class StreamingCheck:
    """Measured fetch timeline vs the analytic term."""

    predicted_layer_s: float     # the model's seconds per unit
    measured_layer_s: float      # median measured seconds per unit
    measured_bps: float          # aggregate measured throughput
    modeled_bps: float           # the model's rate
    ratio: float                 # measured_layer_s / predicted_layer_s

    @property
    def consistent(self) -> bool:
        """Within an order of magnitude — the model is a scheduler input,
        not a cycle-accurate simulator; page cache and file-open overhead
        move absolute numbers while relative ordering survives."""
        return 0.1 <= self.ratio <= 10.0


@dataclasses.dataclass(frozen=True)
class TierRecallCosts:
    """Modeled seconds to recall one KV page into the device tier from
    each rung of the memory hierarchy — the pricing the tiered memory
    manager's cost-model eviction minimizes (expected recall loss =
    hit frequency x the victim's recall cost), in place of plain LRU.

    A host recall moves ``page_bytes`` over the host memory bus
    (``cpu_membw``), a disk recall first reads the page file
    (``disk_speed``) and then still pays the host->device hop. Device is
    zero — the page is already where compute needs it.
    """

    page_bytes: float
    device_s: float = 0.0
    host_s: float = 0.0
    disk_s: float = 0.0

    def cost(self, tier: str) -> float:
        return {"device": self.device_s, "host": self.host_s,
                "disk": self.disk_s}[tier]


def kv_recall_costs(page_bytes: float, *, dev=None,
                    membw: Optional[float] = None,
                    disk_bps: Optional[float] = None) -> TierRecallCosts:
    """Price per-tier KV page recall from a device profile (or explicit
    bandwidths; defaults are a commodity host bus and SSD)."""
    bw = membw if membw is not None else (
        dev.cpu_membw if dev is not None else 10e9)
    dbps = disk_bps if disk_bps is not None else (
        dev.disk_speed() if dev is not None else 500e6)
    host_s = page_bytes / max(bw, 1.0)
    return TierRecallCosts(
        page_bytes=page_bytes, device_s=0.0, host_s=host_s,
        disk_s=page_bytes / max(dbps, 1.0) + host_s)


def tier_recall_crosscheck(costs: TierRecallCosts, tier: str,
                           events: Sequence) -> StreamingCheck:
    """Cross-check a tier's modeled recall term against the measured
    fetch timeline of that tier (``BlockOffloader.events`` for host
    recalls, the disk store's read events for disk recalls), so a
    recall-cost table that drifts from observed stalls is detectable
    instead of silently mis-evicting."""
    predicted = max(costs.cost(tier), 1e-12)
    measured = median_event_duration(events)
    return StreamingCheck(
        predicted_layer_s=predicted, measured_layer_s=measured,
        measured_bps=aggregate_bps(events),
        modeled_bps=costs.page_bytes / predicted,
        ratio=measured / predicted)


def median_event_duration(events: Sequence) -> float:
    """Median duration of a fetch timeline (``PrefetchEvent`` records);
    zero-byte events are excluded."""
    durs = sorted(e.duration for e in events if e.nbytes > 0)
    return durs[len(durs) // 2] if durs else 0.0


def aggregate_bps(events: Sequence) -> float:
    """Aggregate throughput of a fetch timeline."""
    nbytes = sum(e.nbytes for e in events)
    span = sum(e.duration for e in events)
    return nbytes / max(span, 1e-12)
