"""Online adaptation: runtime intent telemetry, drift detection, live relayout
(twin of ``repro.core.adapt``).

The intent pipeline decides a layout *before* production runs (static
analysis + one probe) and then never revisits it — but real workloads change
phase mid-run (write-heavy checkpointing → read-heavy analysis →
metadata-heavy indexing), and a layout dimension you can only set once at
startup is not first-class.  This package closes the loop:

* :mod:`telemetry` — lightweight per-scope counters accumulated on the
  client's device from the very request batches the client already
  routes (production traffic *is* the probe);
* :mod:`drift` — an EWMA divergence test between the live signature and
  the signature the layout decision was made from, with hysteresis so
  transient bursts don't thrash;
* :mod:`redecide` — feeds a drifted signature back through the simulator
  (and optionally the full intent selector) to propose a per-scope mode
  change, gated by predicted steady-state win vs. migration cost;
* :mod:`migrate` — a ``LiveMigrator`` that re-encodes the scope's stored
  chunks old-mode→new-mode through the existing exchange plane
  (``burst_buffer.migrate_rows``) in bounded installments, with dual-epoch
  reads until the watermark completes — lossless at every step;
* :mod:`controller` — the ``AdaptationController.tick()`` control loop
  tying the four together (wired into the train loop's step cadence).

The reference's docs/adaptation.md describes the telemetry schema, the
drift test and the migration protocol (watermark/epoch diagram); the port
follows it.
"""
from repro_torch.core.adapt.controller import (AdaptConfig,
                                               AdaptationController,
                                               TickReport)
from repro_torch.core.adapt.drift import (DriftConfig, DriftDetector,
                                          DriftReport)
from repro_torch.core.adapt.migrate import LiveMigrator, PolicyEpoch
from repro_torch.core.adapt.redecide import (PolicyDelta, gate_delta,
                                             migration_cost_s,
                                             phases_from_signature,
                                             propose_deltas,
                                             signature_workload)
from repro_torch.core.adapt.telemetry import (N_FEATURES, SIG_NAMES,
                                              ScopeTelemetry,
                                              signature_from_phases,
                                              signature_from_stats)

__all__ = [
    "AdaptConfig", "AdaptationController", "TickReport",
    "DriftConfig", "DriftDetector", "DriftReport",
    "LiveMigrator", "PolicyEpoch",
    "PolicyDelta", "gate_delta", "migration_cost_s",
    "phases_from_signature", "propose_deltas", "signature_workload",
    "N_FEATURES", "SIG_NAMES", "ScopeTelemetry",
    "signature_from_phases", "signature_from_stats",
]
