"""Asynchronous continuous-batching serving tier.

Port of ``repro.serve_async``.  The synchronous
:class:`~repro_torch.deploy.engine.SNNServeEngine` serves whoever is
queued when its caller next runs ``step()``.  This package puts a
concurrent front-end on the same engine (same packed model, same
forward, bit-identical per-request results at one bucket size):

* :class:`AsyncSNNServeEngine` — thread-safe ``submit() -> SNNFuture``
  with emplace-on-arrival admission, worker threads that pipeline
  rollouts (host→device transfer of cohort k+1 overlaps cohort k's
  device compute), slot recycling at rollout boundaries, admission
  deadlines resolving as explicit timeouts, graceful drain on close.
* :func:`poisson_schedule` / :func:`run_open_loop_async` /
  :func:`run_open_loop_sync` — seeded open-loop load generation, the
  honest way to compare the tiers' tail latency at a fixed offered
  load (``python -m repro_torch.serve_async.loadgen``).

The tier runs where its engine runs: ``device="cuda"`` by default, the
CPU only when the engine was built with ``device="cpu"``.
"""

from repro_torch.serve_async.engine import (   # noqa: F401
    AsyncEngineConfig,
    AsyncSNNServeEngine,
)
from repro_torch.serve_async.futures import (  # noqa: F401
    STATUS_CANCELLED,
    STATUS_OK,
    STATUS_TIMEOUT,
    AsyncResult,
    SNNFuture,
)
from repro_torch.serve_async.loadgen import (  # noqa: F401
    LoadGenReport,
    poisson_schedule,
    run_open_loop_async,
    run_open_loop_sync,
)
from repro_torch.serve_async.queue import (    # noqa: F401
    Closed,
    Full,
    QueueEntry,
    RequestQueue,
)
from repro_torch.serve_async.slots import SlotManager  # noqa: F401
