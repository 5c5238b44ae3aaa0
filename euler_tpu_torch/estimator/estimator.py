"""The training loop over a device flow
(counterpart: euler_tpu/estimator/estimator.py:28-90, 312-609, 822-881).

The model contract is the JAX package's: calling the model on a batch
returns (embedding, loss, metric_name, metric). Each step draws its batch
on the device from a generator seeded from (cfg.seed + 2, global step), so
the batch stream is a function of the global step, as JAX's `fold_in`
makes it; the draws go through the flow's one `draw_inputs` method. The
batch is hydrated (`hydrate_blocks`, then the feature cache), the loss
back-propagated, and the optimizer steps. Losses stay on the device until
`train` returns.

Checkpoints are the JAX package's format (`training/checkpoint.py`):
flax-order param leaves and optax-order optimizer leaves, so a JAX
`Estimator.restore` reads what `save` wrote, and `restore` reads what the
JAX `Estimator.save` wrote.

Not ported yet: host batch functions, `evaluate`/`infer`, the lax.scan
grouping of steps (`steps_per_call`), the profiler hook and
`TrainingSession`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import hydrate_blocks
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.params import (
    checkpoint_order,
    from_flax_leaf,
    init_like_flax,
    load_optimizer_leaves,
    optimizer_leaves,
    to_checkpoint_leaves,
)
from euler_tpu_torch.training.checkpoint import CheckpointStore


@dataclasses.dataclass
class EstimatorConfig:
    model_dir: str = "/tmp/euler_tpu_model"
    total_steps: int = 100
    learning_rate: float = 0.01
    optimizer: str = "adam"  # adam | adagrad | sgd | momentum
    momentum: float = 0.9
    log_steps: int = 20
    checkpoint_steps: int = 0  # 0 = only at end
    keep_checkpoints: int = 3
    seed: int = 0


# optax's defaults for each optimizer, written out for torch.optim
_OPTIMIZERS = {
    "adam": lambda p, cfg: torch.optim.Adam(
        p, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
    ),
    "adagrad": lambda p, cfg: torch.optim.Adagrad(
        p, lr=cfg.learning_rate, initial_accumulator_value=0.1, eps=1e-7
    ),
    "sgd": lambda p, cfg: torch.optim.SGD(p, lr=cfg.learning_rate),
    "momentum": lambda p, cfg: torch.optim.SGD(
        p, lr=cfg.learning_rate, momentum=cfg.momentum, dampening=0
    ),
}


def make_optimizer(cfg: EstimatorConfig, params) -> torch.optim.Optimizer:
    """torch.optim under optax's conventions: adam eps 1e-8 (bias
    correction as both libraries do it); adagrad with initial accumulator
    0.1 and eps 1e-7; momentum without dampening."""
    if cfg.optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return _OPTIMIZERS[cfg.optimizer](params, cfg)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of global step `step`."""
    s = np.random.SeedSequence([int(seed) + 2, int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


class Estimator:
    """Drives a (emb, loss, metric_name, metric) model over a device flow."""

    def __init__(
        self,
        model: torch.nn.Module,
        flow,
        cfg: EstimatorConfig | None = None,
        feature_cache=None,
        init_params: dict | None = None,
        device=None,
    ):
        """init_params: a state_dict to start from (e.g. `params.from_flax`
        of a flax init); otherwise every Linear is initialised as flax's
        Dense is, from a generator seeded with cfg.seed. Runs on the CUDA
        card unless device="cpu"; the flow and the feature cache must
        live on the same device."""
        if not getattr(flow, "is_device_flow", False):
            raise TypeError(
                "the port's Estimator trains from a device flow (DeviceSageFlow); "
                "host batch functions are not ported yet"
            )
        self.cfg = cfg or EstimatorConfig()
        self.device = resolve_device(device)
        for what, obj in (("flow", flow), ("feature_cache", feature_cache)):
            if obj is not None and obj.device != self.device:
                raise ValueError(f"{what} lives on {obj.device}, the estimator on {self.device}")
        self.flow = flow
        self.feature_cache = feature_cache
        model = model.cpu()
        if init_params is None:
            init_like_flax(model, torch.Generator().manual_seed(self.cfg.seed))
        else:
            model.load_state_dict(init_params)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.cfg, self.model.parameters())
        self.step = 0
        # losses of the most recent train(), published even when it raises
        self.last_losses: list[float] = []

    def batch(self, step: int):
        """The lean batch of global step `step`."""
        gen = step_generator(self.cfg.seed, step, self.device)
        return self.flow.fanout_batch(*self.flow.draw_inputs(gen))

    def _hydrate(self, batch):
        batch = hydrate_blocks(batch)
        return self.feature_cache.hydrate(batch) if self.feature_cache is not None else batch

    def _update(self, batch):
        self.optimizer.zero_grad(set_to_none=True)
        _, loss, _, metric = self.model(self._hydrate(batch))
        loss.backward()
        self.optimizer.step()
        return loss.detach(), metric.detach()

    def train(self, total_steps: int | None = None, log: bool = True, save: bool = True) -> list:
        """Run `total_steps` (default cfg.total_steps) optimizer steps;
        returns their losses and sets `last_losses`."""
        steps = self.cfg.total_steps if total_steps is None else int(total_steps)
        self.model.train()
        losses = []
        t0 = time.time()
        try:
            for _ in range(steps):
                loss, metric = self._update(self.batch(self.step))
                self.step += 1
                losses.append(loss)
                if log and self.step % self.cfg.log_steps == 0:
                    print(
                        f"step {self.step}: loss={float(loss):.4f} "
                        f"metric={float(metric):.4f} ({self.step / (time.time() - t0):.1f} it/s)"
                    )
                if self.cfg.checkpoint_steps and self.step % self.cfg.checkpoint_steps == 0:
                    self.save()
        finally:
            self.last_losses = torch.stack(losses).cpu().tolist() if losses else []
        if save:
            self.save()
        return list(self.last_losses)

    def _named_params(self) -> dict:
        return dict(self.model.named_parameters())

    def save(self) -> str:
        """Commit one retained atomic checkpoint (`ckpt_<step>/` under
        model_dir); returns its path."""
        store = CheckpointStore(self.cfg.model_dir, keep=self.cfg.keep_checkpoints)
        return store.save_leaves(
            self.step,
            to_checkpoint_leaves(self.model.state_dict()),
            optimizer_leaves(self.cfg.optimizer, self.optimizer, self._named_params()),
            {"seed": int(self.cfg.seed)},
        )

    def restore(self) -> bool:
        """Restore the newest complete checkpoint (either package's);
        False when there is none."""
        store = CheckpointStore(self.cfg.model_dir, keep=self.cfg.keep_checkpoints)
        if store.latest_step() is None:
            return False
        ckpt = store.load()
        keys = checkpoint_order(self.model.state_dict())
        if len(ckpt["params"]) != len(keys):
            raise ValueError(
                f"checkpoint carries {len(ckpt['params'])} param leaves where the "
                f"model has {len(keys)}"
            )
        self.model.load_state_dict(
            {k: from_flax_leaf(k, leaf) for k, leaf in zip(keys, ckpt["params"])}
        )
        load_optimizer_leaves(
            self.cfg.optimizer, self.optimizer, self._named_params(), ckpt["opt_state"]
        )
        self.step = int(ckpt["step"])
        return True
