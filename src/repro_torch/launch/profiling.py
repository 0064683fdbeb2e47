"""Opt-in ``torch.profiler`` tracing for the serve and train hot loops.

Port of ``repro.launch.profiling``.  The tuning knobs of the port
(engine batch buckets, the kernels' launch plans) are set from traces,
not guesses: wrap the hot loop in :func:`maybe_trace` and open the trace
it writes in ui.perfetto.dev or chrome://tracing (TensorBoard's profiler
plugin reads the directory too) to see per-kernel device time, host
gaps and the ``snn_serve_step/b<bucket>`` ranges the serve engine
records.  Launchers expose it as ``--profile [DIR]``:

    PYTHONPATH=src python -m repro_torch.launch.serve_snn --full --profile
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --profile build/trace/train

Disabled (``log_dir`` falsy) it is a no-op that starts nothing, so call
sites wrap unconditionally.  On a CUDA run the profiler records the
card's activity too, and a trace that caught no device event is an
error: a device trace without kernels would mislead whoever reads it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Iterator, Optional

#: where a bare ``--profile`` writes: ``build/trace/<launcher>`` at the
#: repository root (git-ignored)
TRACE_DIR = Path(__file__).resolve().parents[3] / "build" / "trace"


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str], device="cuda"
                ) -> Iterator[Optional[str]]:
    """Profile the body with ``torch.profiler`` when ``log_dir`` is set,
    else do nothing.  ``device`` is the device the traced work runs on:
    a CUDA device adds the card's activity (kernels, copies) to the
    host's.  On exit the trace is written as Chrome/Perfetto JSON to
    ``<log_dir>/<host>.<pid>.<ms>.pt.trace.json`` and its path printed.
    Yields the directory traced into (or None)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # all threads: the async tier's workers run the serve steps
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield log_dir
        if on_card:
            torch.cuda.synchronize(device)
    if on_card and not any(e.device_type == DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError(
            f"torch.profiler recorded no device event on {device}: the "
            f"trace would show host activity only")
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                 f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}; open it in "
          f"ui.perfetto.dev or chrome://tracing")


def add_profile_flag(ap, default_dir: str) -> None:
    """The shared ``--profile [DIR]`` launcher flag.

    Bare ``--profile`` traces into ``default_dir``; an explicit argument
    overrides the destination; omitted entirely, ``args.profile`` is
    None and :func:`maybe_trace` is a no-op.
    """
    ap.add_argument("--profile", nargs="?", const=default_dir, default=None,
                    metavar="DIR",
                    help="trace the hot loop with torch.profiler into DIR "
                         f"(default {default_dir}) for perfetto/chrome "
                         "tracing")
