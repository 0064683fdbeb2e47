"""Training loop: one-device step, async checkpointing, watchdog, restarts.

Port of ``repro.train.trainer``.  The loop is deliberately boring; the
failure behaviour lives in distributed/{checkpoint,fault_tolerance}.py.

Observability: every step's loss / lr / grad-norm / duration goes through
the shared metrics registry (``repro_torch.obs``; the JAX trainer's
instruments by name: ``train_steps_total``, ``train_step_us``,
``train_loss``, ``train_lr``, ``train_grad_norm`` and the ``train_step``
event; no-ops while the registry is disabled) and through ``hooks``,
per-step callbacks ``fn(info)`` with ``info = {step, loss, lr,
grad_norm, dt_s, straggler}``.  Hooks observe; they must not mutate
state.

The trainer runs on ``device`` (default ``"cuda"``; without a card it
raises unless given ``device="cpu"``).  With ``mesh=`` (a ``DeviceMesh``
or an abstract mesh) it builds ``_pshard``, the params' shardings under
the sharding rules, from the meta-device param tree, as the JAX trainer
does; like JAX's, the loop does not read it, so the params stay on
``device`` unplaced (the sharded step is ``launch.steps.make_train_step``
on params placed by ``distributed.sharding.distribute``).  A step's time
is taken around the step and the read of its loss, which waits for the
device.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault_tolerance import (
    FailureInjector,
    StepWatchdog,
    WatchdogConfig,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.train import optimizer as opt

#: the default checkpoint directory: ``build/ckpt/train`` at the
#: repository root (git-ignored)
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "ckpt" / "train")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    seed: int = 0
    ckpt_dir: str = DEFAULT_CKPT_DIR
    ckpt_every: int = 25
    ckpt_keep: int = 3
    log_every: int = 10
    async_ckpt: bool = True
    opt: opt.OptConfig = opt.OptConfig(warmup_steps=10, total_steps=1000)


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, mesh=None,
                 injector: Optional[FailureInjector] = None,
                 log: Callable[[str], None] = print,
                 hooks: Optional[List[Callable[[dict], None]]] = None,
                 registry: Optional["obs.MetricsRegistry"] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.tcfg = tcfg
        self.injector = injector
        self.log = log
        self.hooks = list(hooks or [])
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.watchdog = StepWatchdog(WatchdogConfig())
        self.history: list = []

        # instruments bind once (no-op handles when the registry is
        # disabled, as in the serve engine)
        self.obs = registry if registry is not None else \
            obs.default_registry()
        m = self.obs
        self._m_steps = m.counter("train_steps_total", "optimizer steps")
        self._m_step_us = m.histogram("train_step_us", obs.LATENCY_EDGES_US,
                                      "wall time per optimizer step")
        self._m_loss = m.gauge("train_loss", "last step loss")
        self._m_lr = m.gauge("train_lr", "last step learning rate")
        self._m_grad_norm = m.gauge("train_grad_norm",
                                    "last step global grad norm")

        self._step_fn = make_train_step(cfg, tcfg.opt)
        if mesh is not None:
            from repro_torch.distributed import sharding as shd
            from repro_torch.launch import specs as S

            self._pshard = shd.to_shardings(
                shd.param_specs(S.param_specs_struct(cfg), mesh), mesh)

    # -- state --------------------------------------------------------------

    def init_state(self, seed: int = 0):
        from repro_torch.models.api import get_model

        params = get_model(self.cfg).init(seed, device=self.device)
        return params, opt.init(params), 0

    def restore_or_init(self):
        latest = self.ckpt.latest_step()
        params, opt_state, step = self.init_state(self.tcfg.seed)
        if latest is not None:
            state = self.ckpt.restore(
                latest, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            step = latest
            self.log(f"[trainer] restored checkpoint step={latest}")
        return params, opt_state, step

    # -- loop ---------------------------------------------------------------

    def run(self) -> dict:
        params, opt_state, start = self.restore_or_init()
        it = synthetic.lm_iterator(
            self.cfg.vocab, self.tcfg.batch, self.tcfg.seq,
            seed=self.tcfg.seed, start_step=start,
        )
        losses = []
        for step in range(start, self.tcfg.steps):
            batch = next(it)
            if self.injector is not None:
                self.injector.check(step)
            # perf_counter, not time.time(): step durations feed the
            # watchdog's straggler detection
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device, torch.int64)
                     for k, v in batch.items()}
            params, opt_state, metrics = self._step_fn(
                params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            verdict = self.watchdog.observe(step, dt)
            losses.append(loss)
            self.history.append({"step": step, "loss": loss, "dt": dt,
                                 "verdict": verdict})
            lr = float(metrics["lr"])
            gnorm = float(metrics.get("grad_norm", 0.0))
            self._m_steps.inc()
            self._m_step_us.observe(dt * 1e6)
            self._m_loss.set(loss)
            self._m_lr.set(lr)
            self._m_grad_norm.set(gnorm)
            self.obs.event("train_step", step=step, loss=loss,
                           dt_us=dt * 1e6, grad_norm=gnorm)
            info = {"step": step, "loss": loss, "lr": lr,
                    "grad_norm": gnorm, "dt_s": dt,
                    "straggler": verdict != "ok"}
            for hook in self.hooks:
                hook(info)
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step={step} loss={loss:.4f} "
                         f"dt={dt*1e3:.0f}ms lr={lr:.2e}")
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1,
                               {"params": params, "opt": opt_state},
                               blocking=not self.tcfg.async_ckpt)
        self.ckpt.wait()
        self.ckpt.save(self.tcfg.steps, {"params": params, "opt": opt_state})
        return {"final_loss": float(np.mean(losses[-5:])),
                "first_loss": losses[0] if losses else float("nan"),
                "losses": losses,
                "stragglers": self.watchdog.straggler_steps}
