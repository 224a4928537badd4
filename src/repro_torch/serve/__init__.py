"""Multi-viewer batched render serving over one Gaussian scene.

Layers, bottom up:
  * ``repro_torch.core.pipeline`` — the two-phase frame over
    ``SceneShared``/``ViewerPrivate`` state and its slot-batched shade;
  * ``stepper``   — ``BatchedStepper`` (pose-cell sort scheduler and one
    scene-major shade per tick) and ``SequentialStepper`` (per-viewer
    ``render_step``), split into ``plan_step`` / ``step_dispatch`` /
    ``step_finish``;
  * ``session``   — viewer sessions (``scene_id``, frame ``pace``) and the
    slot manager, whose tick is ``plan_tick`` / ``apply_plan`` /
    ``observe_tick``, with slot oversubscription, the hardened device leg
    and crash-consistent checkpoints (``repro_torch.checkpoint``);
  * ``events``    — ``TickPlan``, the ``SyncDriver`` (virtual clock) and the
    ``ThreadedDriver`` (host planning on a worker thread);
  * ``fleet``     — the elastic multi-device fleet: one worker per device,
    routing, live migration and device-loss rollback, under the
    ``SyncFleetDriver`` or the ``ThreadedFleetDriver``;
  * ``streaming`` — pose-cell scene residency through a device arena;
  * ``faults``    — seeded, replayable fault traces and their injector;
  * ``traffic``   — replayable arrival traces with per-viewer pacing;
  * ``telemetry`` — per-session and per-tick rollups;
  * ``render``    — the CLI (``python -m repro_torch.serve.render``).
"""
from .events import HostTiming, SyncDriver, ThreadedDriver, TickPlan
from .fleet import (FleetManager, SyncFleetDriver, ThreadedFleetDriver,
                    serve_fleet)
from .session import SessionManager, ViewerSession
from .stepper import BatchedStepper, SequentialStepper, TickTiming
from .telemetry import SessionTelemetry, aggregate, format_table, tick_rollup
from .traffic import TrafficTrace, make_trace

__all__ = [
    'BatchedStepper', 'SequentialStepper', 'SessionManager', 'TickTiming',
    'ViewerSession', 'SessionTelemetry', 'aggregate', 'format_table',
    'tick_rollup', 'TickPlan', 'HostTiming', 'SyncDriver', 'ThreadedDriver',
    'FleetManager', 'SyncFleetDriver', 'ThreadedFleetDriver', 'serve_fleet',
    'TrafficTrace', 'make_trace',
]
