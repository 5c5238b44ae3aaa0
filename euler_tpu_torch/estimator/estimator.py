"""The train / evaluate / infer loops
(counterpart: euler_tpu/estimator/estimator.py:28-90, 312-881, 1047-1163).

The model contract is the JAX package's: calling the model on a batch
returns (embedding, loss, metric_name, metric). Two lanes feed it:

- a host batch function: `batch_fn()` returns a tuple of model args —
  numpy `MiniBatch`es (`node_batches`, `unsupervised_batches`'s (src,
  pos, negs), a `ResumableSource` or a `Prefetcher`), which go through
  `to_device` → `hydrate_blocks` → the feature cache, `LayerwiseBatch`es
  and `RelMiniBatch`es (moved by `to_device`, their int32 hop_ids too),
  or dicts of numpy arrays (the skip-gram and KG sources) and `GraphBatch`es
  (`graph_label_batches`), whose arrays are moved as they are (int32 ids
  stay int32);
- a device flow (`DeviceSageFlow`, `DeviceUnsupSageFlow`,
  `DeviceWalkFlow`, `DeviceEdgeFlow`, `DeviceKGFlow`,
  `DeviceWholeGraphFlow`, `DeviceRelationFlow`, `DeviceLayerwiseFlow`,
  `DeviceGaeFlow`, `DeviceDgiFlow`): each step draws its
  batch on the device from a generator seeded from (cfg.seed + 2, global
  step), so the batch stream is a function of the global step, as JAX's
  `fold_in` makes it; the draws go through the flow's one `draw_inputs`
  method and its deterministic `make_batch`, which returns a MiniBatch,
  a tuple of them (the model's args), a dict, a GraphBatch, a
  LayerwiseBatch or a RelMiniBatch.

A model may declare random streams of its own (`rng_collections`, VGAE's
"reparam" noise, as in the JAX package): each step's draws come from
`rng_generator(cfg.seed, step)` through the model's `draw_rngs`, outside
the step (a captured step takes them as an input), and reach the model
as `rngs=`.

`EstimatorConfig.steps_per_call` = K > 1 groups the steps into calls of
K, as JAX's lax.scan does (`_train_scan`): the host lane then takes one
K-stacked `batch_fn()` item a call (`stack_batches`). On the CUDA card a
call replays one captured optimizer step K times (`graph_step.py`); on
the CPU the same steps run eagerly. On the card Adam is built
`capturable=True` for every K, so K = 1 and K > 1 share one update rule.

Losses stay on the device until `train` drains them (every 4 096 steps
and at the end). Checkpoints are the JAX package's format
(`training/checkpoint.py`): flax-order param leaves and optax-order
optimizer leaves, so each package restores what the other saved.

Not ported yet: meshes, `pipelined_batches` and the shard-failure policy
of remote batch sources.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import MiniBatch, hydrate_blocks, to_device, upgrade_lean_host
from euler_tpu_torch.dataflow.layerwise import LayerwiseBatch
from euler_tpu_torch.dataflow.relation import RelMiniBatch
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.estimator.graph_step import StepGraph, signature, tree_map
from euler_tpu_torch.ops import kernel_mode
from euler_tpu_torch.params import (
    init_like_flax,
    load_optimizer_leaves,
    optimizer_leaves,
    state_dict_from_leaves,
    to_checkpoint_leaves,
)
from euler_tpu_torch.training.checkpoint import CheckpointStore

# losses kept on the device before a drain to the host: one live scalar
# a step would otherwise pin an unbounded number of small buffers
DRAIN_EVERY = 4096
# the batch dataclasses `to_device` moves (hop_ids included)
BATCH_TYPES = (MiniBatch, LayerwiseBatch, RelMiniBatch)


@dataclasses.dataclass
class EstimatorConfig:
    model_dir: str = "/tmp/euler_tpu_model"
    batch_size: int = 32
    total_steps: int = 100
    learning_rate: float = 0.01
    optimizer: str = "adam"  # adam | adagrad | sgd | momentum
    momentum: float = 0.9
    log_steps: int = 20
    checkpoint_steps: int = 0  # 0 = only at end
    keep_checkpoints: int = 3
    seed: int = 0
    # when set, one torch.profiler trace of `profile_steps` steps is
    # written there once, starting at global step `profile_start_step`
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_steps: int = 5
    # optimizer steps a call: K > 1 replays one captured step K times on
    # the card (host lane: feed K-stacked batches, `stack_batches`)
    steps_per_call: int = 1


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad's update (`scale_by_rss` then `scale(-lr)`): s += g²;
    p += (g · rsqrt(s + eps)) · (-lr), with s starting at
    `initial_accumulator_value`. torch's Adagrad divides by sqrt(s) + eps
    instead. The state slot keeps torch's name, "sum"."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdagrad takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "sum" not in st:
                    st["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                g = p.grad
                s = st["sum"].add_(g * g)
                p.add_((g * torch.rsqrt(s + group["eps"])) * (-group["lr"]))


# optax's defaults for each optimizer, written out for torch
_OPTIMIZERS = {
    "adam": lambda p, cfg, capturable: torch.optim.Adam(
        p, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, capturable=capturable
    ),
    "adagrad": lambda p, cfg, capturable: OptaxAdagrad(p, lr=cfg.learning_rate),
    "sgd": lambda p, cfg, capturable: torch.optim.SGD(p, lr=cfg.learning_rate),
    "momentum": lambda p, cfg, capturable: torch.optim.SGD(
        p, lr=cfg.learning_rate, momentum=cfg.momentum, dampening=0
    ),
}


def make_optimizer(cfg: EstimatorConfig, params, capturable: bool = False) -> torch.optim.Optimizer:
    """torch optimizers under optax's conventions: adam eps 1e-8 (bias
    correction as both libraries do it); adagrad as optax computes it
    (`OptaxAdagrad`: initial accumulator 0.1, eps 1e-7); momentum without
    dampening. capturable: Adam's rule that a CUDA graph can capture (its
    step count on the device); the others capture as they are."""
    if cfg.optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return _OPTIMIZERS[cfg.optimizer](params, cfg, capturable)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of global step `step`."""
    s = np.random.SeedSequence([int(seed) + 2, int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def rng_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the model's own random draws (its
    `rng_collections`, VGAE's "reparam" noise) at global step `step`: the
    port's `fold_in(PRNGKey(seed + 1), step)`."""
    s = np.random.SeedSequence([int(seed) + 1, int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


class Estimator:
    """Drives a (emb, loss, metric_name, metric) model over a host batch
    function or a device flow."""

    def __init__(
        self,
        model: torch.nn.Module,
        batch_fn: Callable[[], tuple],
        cfg: EstimatorConfig | None = None,
        mesh=None,
        feature_cache=None,
        init_params: dict | None = None,
        *,
        device=None,
    ):
        """batch_fn: a host batch function returning a tuple of model
        args (`(MiniBatch,)` for supervised heads), or a device flow
        (`is_device_flow`). init_params: a state_dict to start from (e.g.
        `params.from_flax` of a flax init); otherwise every Linear is
        initialised as flax's Dense is, from a generator seeded with
        cfg.seed, and — on the host lane — the first train, evaluate,
        infer, save or restore consumes one `batch_fn()` draw, where the
        JAX package initialises from it. Runs on the CUDA card unless
        device="cpu"; a device flow and the feature cache must live on
        the same device. `mesh` is not ported yet."""
        if mesh is not None:
            raise NotImplementedError("Estimator(mesh=) is not ported yet")
        self.cfg = cfg or EstimatorConfig()
        self.device = resolve_device(device)
        is_flow = getattr(batch_fn, "is_device_flow", False)
        self.flow = batch_fn if is_flow else None
        self.batch_fn = None if is_flow else batch_fn
        for what, obj in (("flow", self.flow), ("feature_cache", feature_cache)):
            if obj is not None and obj.device != self.device:
                raise ValueError(f"{what} lives on {obj.device}, the estimator on {self.device}")
        self.feature_cache = feature_cache
        model = model.cpu()
        if init_params is None:
            init_like_flax(model, torch.Generator().manual_seed(self.cfg.seed))
        else:
            model.load_state_dict(init_params)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.cfg, self.model.parameters(),
                                        capturable=self.device.type == "cuda")
        self.step = 0
        # captured steps by input signature (steps_per_call > 1 on the card)
        self._graphs: dict = {}
        self.captures = 0
        self._init_draw = init_params is None and not is_flow
        # models may declare random streams of their own (VGAE's
        # "reparam"): drawn outside the step, from `rng_generator`, and
        # passed to the model as `rngs=`
        self._rng_names = tuple(getattr(model, "rng_collections", ()))
        self._profiled = False
        self._profile_first = 0
        # losses of the most recent train(), published even when it raises
        self.last_losses: list[float] = []
        self._embed = None  # embed_program(), built once

    # -- batches ------------------------------------------------------------

    def _ensure_init(self) -> None:
        """Consume the draw JAX's `_ensure_init` initialises from
        (estimator.py:411-416), once, so the batch stream and every
        source cursor stay aligned with the JAX package's."""
        if self._init_draw:
            self._init_draw = False
            self.batch_fn()

    def batch(self, step: int):
        """The batch of global step `step` (device flows): a lean
        MiniBatch, a tuple of them or a dict, as the flow makes it."""
        gen = step_generator(self.cfg.seed, step, self.device)
        return self.flow.make_batch(*self.flow.draw_inputs(gen))

    def _next_batch(self) -> tuple:
        """One step's args on the device: the global step's device-flow
        batch, or the next host batch, moved."""
        if self.flow is not None:
            return as_args(self.batch(self.step))
        return args_to_device(self.batch_fn(), self.device)

    def _hydrate(self, batch):
        batch = hydrate_blocks(batch)
        return self.feature_cache.hydrate(batch) if self.feature_cache is not None else batch

    def _model_args(self, args: tuple) -> tuple:
        """The model's args from args on the device: each MiniBatch
        hydrated."""
        return tuple(self._hydrate(b) if isinstance(b, MiniBatch) else b for b in args)

    def _rng_kwargs(self, rngs) -> dict:
        return {} if rngs is None else {"rngs": rngs}

    def _model_rngs(self, step: int, args=None) -> dict | None:
        """The model's own draws for global step `step` (None when it
        declares no random stream): `model.draw_rngs(generator, rows,
        device)`, rows being the batch's root count — the first MiniBatch's
        of the host batch `args`, or the flow's batch size."""
        if not self._rng_names:
            return None
        if args is None:
            rows = self.flow.batch_size
        else:
            rows = next(len(a.root_idx) for a in args if isinstance(a, MiniBatch))
        return self.model.draw_rngs(rng_generator(self.cfg.seed, step, self.device), rows,
                                    self.device)

    def _update(self, batch, rngs=None):
        self.optimizer.zero_grad(set_to_none=True)
        _, loss, _, metric = self.model(*self._model_args(batch), **self._rng_kwargs(rngs))
        loss.backward()
        self.optimizer.step()
        return loss.detach(), metric.detach()

    def _step_of(self, x):
        """One optimizer step on a call input: the flow's draws or a host
        batch, paired with the model's draws when it declares
        rng_collections."""
        if self._rng_names:
            x, rngs = x
            return self._update(self._batch_of(x), rngs)
        return self._update(self._batch_of(x))

    # -- calls of steps_per_call steps (counterpart: estimator.py:516-542,
    # 651-727) ---------------------------------------------------------------

    def _batch_of(self, x) -> tuple:
        """A call step's args on the device from its input: a device
        flow's draws go through `make_batch`; a host batch is moved."""
        if self.flow is None:
            return args_to_device(x, self.device)
        return as_args(self.flow.make_batch(*x))

    def _call_inputs(self, n: int, stacked: bool) -> Iterator:
        """The inputs of the next n steps: each global step's draws
        (device flows), or one `batch_fn()` item — when `stacked`, a
        K-stacked item whose first n slices are the steps' batches, moved
        to the card at once when it runs graphs. A model with
        rng_collections gets each step's input paired with its own draws
        (`_model_rngs`)."""
        first = self.step
        for i, x in enumerate(self._step_inputs(n, stacked)):
            yield x if not self._rng_names else (x, self._model_rngs(
                first + i, None if self.flow is not None else x))

    def _step_inputs(self, n: int, stacked: bool) -> Iterator:
        first = self.step
        if self.flow is not None:
            for i in range(n):
                yield self.flow.draw_inputs(step_generator(self.cfg.seed, first + i, self.device))
            return
        item = self.batch_fn()
        if not stacked:
            yield item
            return
        if self.device.type == "cuda":
            item = args_to_device(item, self.device)
        for i in range(n):
            yield tree_map(lambda v: v[i] if isinstance(v, (np.ndarray, torch.Tensor)) else v,
                           item)

    def _graph_step(self, x):
        """One step on the card, a replay of the step captured for x's
        signature. A signature's first step runs eagerly on a side stream
        (a real step, which also makes the optimizer state); then the
        step is captured."""
        key = (signature(x), kernel_mode())
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay(x)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._step_of(x)
        main.wait_stream(side)
        self.optimizer.zero_grad(set_to_none=True)
        self._graphs[key] = StepGraph(self._step_of, x)
        self.captures += 1
        return out

    def _call(self, n: int, k: int) -> tuple[list, torch.Tensor]:
        """n optimizer steps as one call of a train at steps_per_call k:
        (their device losses, the last step's metric). On the card at
        k > 1 each step replays its captured graph; otherwise the steps
        run eagerly."""
        graphs = k > 1 and self.device.type == "cuda"
        losses, metric = [], None
        for x in self._call_inputs(n, k > 1):
            if graphs:
                loss, metric = self._graph_step(x)
                loss = loss.clone()  # the next replay overwrites the static loss
            else:
                loss, metric = self._step_of(x)
            losses.append(loss)
            self.step += 1
        return losses, metric

    # -- profiling ----------------------------------------------------------

    def _maybe_profile(self, prof, span: int):
        """Start the one profiler trace at `profile_start_step`; stop and
        write it `span` steps later. Returns the live profile or None."""
        cfg = self.cfg
        if prof is None and cfg.profile_dir and not self._profiled \
                and self.step >= cfg.profile_start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            self._profile_first = self.step
            self._profiled = True
        elif prof is not None and self.step >= self._profile_first + span:
            self._stop_profile(prof)
            prof = None
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.cfg.profile_dir, f"trace_step{self._profile_first}.json")
        )

    # -- train / evaluate / infer / train_and_evaluate ----------------------

    def train(self, total_steps: int | None = None, log: bool = True, save: bool = True) -> list:
        """Run `total_steps` (default cfg.total_steps) optimizer steps;
        returns their losses and sets `last_losses`, also when a step
        raises (then a checkpoint is saved best-effort). The steps go in
        calls of K = steps_per_call, as `_train_scan` groups them
        (estimator.py:651-727): `divmod(steps, K)` calls, then the
        remainder as one more call, which on the host lane uses the first
        `steps % K` slices of one more stacked item. Losses drain every
        `4096 // K` calls; a log or checkpoint falls in the call whose
        steps cross its cadence; the profile spans at least one call."""
        self._ensure_init()
        steps = self.cfg.total_steps if total_steps is None else int(total_steps)
        self.model.train()
        k = max(int(self.cfg.steps_per_call), 1)
        history: list = []  # device losses not yet drained
        fetched: list[float] = []
        drain_every = max(DRAIN_EVERY // k, 1) * k
        span = max(self.cfg.profile_steps, k)
        calls, remainder = divmod(steps, k)
        prof = None
        t0 = time.time()
        try:
            for _ in range(calls):
                prof = self._maybe_profile(prof, span)
                losses, metric = self._call(k, k)
                history.extend(losses)
                if len(history) >= drain_every:
                    fetched.extend(_drain(history))
                    history = []
                if log and self.step % max(self.cfg.log_steps, 1) < k:
                    print(
                        f"step {self.step}: loss={float(losses[-1]):.4f} "
                        f"metric={float(metric):.4f} ({self.step / (time.time() - t0):.1f} it/s)"
                    )
                if self.cfg.checkpoint_steps and self.step % self.cfg.checkpoint_steps < k:
                    self.save()
            if prof is not None:
                self._stop_profile(prof)
                prof = None
            if remainder:
                history.extend(self._call(remainder, k)[0])
        finally:
            self._finish_train(history, fetched, prof, save)
        return list(self.last_losses)

    def _finish_train(self, history, fetched, prof, save) -> None:
        """The train loop's epilogue, run from a `finally`
        (counterpart: estimator.py:610-649): stop a live profile, drain
        the device losses, publish what was fetched on `last_losses`, and
        save. While an error unwinds, the drain and the save are
        best-effort, so the original error is the one surfaced; on the
        clean path a failure raises."""
        exc_live = sys.exc_info()[0] is not None
        if prof is not None:
            try:
                self._stop_profile(prof)
            except Exception:
                if not exc_live:
                    raise
        if history:
            try:
                fetched.extend(_drain(history))
            except Exception:
                if not exc_live:
                    raise
        self.last_losses = list(fetched)
        if save:
            if exc_live:
                try:
                    self.save()
                except Exception as e:
                    print(f"# estimator: best-effort checkpoint after a raising train "
                          f"loop failed: {e!r}", file=sys.stderr)
            else:
                self.save()

    def evaluate(self, batches: Iterable[tuple]) -> dict:
        """Mean loss and metric over host batches: {"loss", <metric name>}.
        A model's own random draws come from step 0's generator anew for
        every batch, as JAX's `_rngs(0)`."""
        self._ensure_init()
        name = None
        losses, metrics = [], []
        with torch.inference_mode():
            for batch in batches:
                rngs = self._model_rngs(0, batch)
                _, loss, name, metric = self.model(
                    *self._model_args(args_to_device(batch, self.device)),
                    **self._rng_kwargs(rngs))
                losses.append(float(loss))
                metrics.append(float(metric))
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            (name or "metric"): float(np.mean(metrics)) if metrics else float("nan"),
        }

    def embed_program(self) -> Callable:
        """`batch -> embeddings` (a device tensor): what `infer` runs on
        each host MiniBatch — moved, hydrated (the feature cache's rows
        too) and through `model.embed`. One object an Estimator:
        `InferenceRuntime` serves its engine's."""
        if self._embed is None:

            def embed(batch: MiniBatch) -> torch.Tensor:
                with torch.inference_mode():
                    return self.model.embed(
                        *self._model_args(args_to_device((batch,), self.device)))

            self._embed = embed
        return self._embed

    def infer(
        self, batches: Iterable[tuple], ids: Iterable[np.ndarray], worker: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        """Embeds batches; writes embedding_{worker}.npy + ids_{worker}.npy
        under model_dir. Returns (ids, embeddings)."""
        self._ensure_init()
        embed = self.embed_program()
        embs, all_ids = [], []
        for batch, chunk_ids in zip(batches, ids):
            emb = embed(batch[0]).float().cpu().numpy()
            embs.append(emb[: len(chunk_ids)])
            all_ids.append(np.asarray(chunk_ids))
        emb = np.concatenate(embs) if embs else np.zeros((0, 0))
        idv = np.concatenate(all_ids) if all_ids else np.zeros((0,), np.uint64)
        os.makedirs(self.cfg.model_dir, exist_ok=True)
        np.save(os.path.join(self.cfg.model_dir, f"embedding_{worker}.npy"), emb)
        np.save(os.path.join(self.cfg.model_dir, f"ids_{worker}.npy"), idv)
        return idv, emb

    def train_and_evaluate(self, eval_batches_fn: Callable[[], Iterable], eval_every: int):
        """Alternate `eval_every` train steps and one evaluate of
        `eval_batches_fn()` up to cfg.total_steps; returns the evaluations."""
        results = []
        remaining = self.cfg.total_steps
        while remaining > 0:
            chunk = min(eval_every, remaining)
            self.train(chunk)
            results.append(self.evaluate(eval_batches_fn()))
            remaining -= chunk
        return results

    # -- checkpointing ------------------------------------------------------

    def _named_params(self) -> dict:
        return dict(self.model.named_parameters())

    def state_leaves(self) -> tuple[list, list]:
        """(param leaves, optimizer leaves): host numpy copies in the JAX
        package's checkpoint order."""
        return (
            to_checkpoint_leaves(self.model.state_dict()),
            optimizer_leaves(self.cfg.optimizer, self.optimizer, self._named_params()),
        )

    def load_leaves(self, params_leaves, opt_leaves) -> None:
        """Set the params and the optimizer state from checkpoint-order
        leaves (either package's)."""
        self.model.load_state_dict(state_dict_from_leaves(self.model.state_dict(), params_leaves))
        load_optimizer_leaves(
            self.cfg.optimizer, self.optimizer, self._named_params(), opt_leaves
        )
        # the optimizer state is new tensors: captured steps read the old
        self._graphs.clear()

    def save(self) -> str:
        """Commit one retained atomic checkpoint (`ckpt_<step>/` under
        model_dir); returns its path."""
        self._ensure_init()
        store = CheckpointStore(self.cfg.model_dir, keep=self.cfg.keep_checkpoints)
        p, o = self.state_leaves()
        return store.save_leaves(self.step, p, o, {"seed": int(self.cfg.seed)})

    def restore(self) -> bool:
        """Restore the newest complete checkpoint (either package's);
        False when there is none."""
        store = CheckpointStore(self.cfg.model_dir, keep=self.cfg.keep_checkpoints)
        if store.latest_step() is None:
            return False
        self._ensure_init()
        ckpt = store.load()
        self.load_leaves(ckpt["params"], ckpt["opt_state"])
        self.step = int(ckpt["step"])
        return True


def as_args(batch) -> tuple:
    """A flow's batch as model args: a tuple is the args, anything else
    the one arg (counterpart: estimator.py:267-276)."""
    return batch if isinstance(batch, tuple) else (batch,)


def args_to_device(args: tuple, device) -> tuple:
    """Model args on `device`: MiniBatches through `to_device`; in a dict
    or a dataclass (a GraphBatch) each array or tensor moved, dtypes
    kept; anything else as it is."""

    def put(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return tuple(to_device(b, device) if isinstance(b, BATCH_TYPES) else tree_map(put, b)
                 for b in args)


def _drain(history: list) -> list[float]:
    """Device losses (scalars or [k] per call) → host floats, in order."""
    return torch.cat([h.reshape(-1) for h in history]).cpu().tolist()


def _stack_leaf(*xs):
    """K leaves → one: numpy arrays (or tensors: a lean batch's bf16
    weights) stacked on a new leading axis; anything else (ints, None)
    must be equal, as the static parts of a JAX pytree must be."""
    arrays = [isinstance(x, (np.ndarray, torch.Tensor)) for x in xs]
    if all(arrays):
        if all(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack(xs)
        return np.stack(xs)
    if any(arrays) or any(x != xs[0] for x in xs):
        raise ValueError(f"leaves differ: {[type(x).__name__ for x in xs]}")
    return xs[0]


def stack_batches(batch_fn: Callable[[], tuple], k: int) -> Callable[[], tuple]:
    """Wrap a batch source to return K batches stacked on a leading axis,
    for `EstimatorConfig.steps_per_call=K` (counterpart:
    estimator.py:926-960). A window that does not stack (a lean flow that
    downgraded mid-window: some batches carry masks and weights, others
    None) is stacked again after `upgrade_lean_host` on every batch,
    which is exact for the lean ones; a window that still differs in
    structure raises."""

    def stack(batches):
        return tree_map(_stack_leaf, *batches)

    def fn():
        batches = [batch_fn() for _ in range(k)]
        try:
            return stack(batches)
        except ValueError:
            batches = [tuple(upgrade_lean_host(x) for x in bt) for bt in batches]
            try:
                return stack(batches)
            except ValueError as e:
                raise ValueError(
                    "steps_per_call>1 requires every batch in a window to "
                    "have identical pytree structure; got a mix that lean "
                    "hydration could not reconcile (a batch_fn with "
                    f"varying structure?). Original error: {e}"
                ) from e

    return fn


# ---- host batch sources (counterpart: estimator.py:1047-1163) -------------


def node_batches(graph, flow, batch_size: int, node_type: int = -1, rng=None) -> Callable:
    """Training source: `batch_size` sampled roots a call, through
    `flow.query`. (The JAX package's shard-failure policy serves remote
    graphs and is not ported.)"""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        roots = graph.sample_node(batch_size, node_type, rng=rng)
        return (flow.query(roots),)

    return fn


def edge_batches(graph, flow, batch_size: int, edge_type: int = -1, rng=None) -> Callable:
    """Training source over sampled edges: (src batch, dst batch), the dst
    as the positive context (counterpart: estimator.py:1069-1080)."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        edges = graph.sample_edge(batch_size, edge_type, rng=rng)
        return (flow.query(edges[:, 0]), flow.query(edges[:, 1]))

    return fn


def unsupervised_batches(
    graph,
    flow,
    batch_size: int,
    node_type: int = -1,
    edge_types=None,
    num_negs: int = 5,
    neg_type: int = -1,
    rng=None,
) -> Callable:
    """(src, pos, negs) source of the unsupervised heads
    (counterpart: estimator.py:1083-1104): pos is a sampled 1-hop
    neighbour of src (src itself where it has none), negs are
    `batch_size * num_negs` globally sampled nodes."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        src = graph.sample_node(batch_size, node_type, rng=rng)
        nbr, _, _, mask, _ = graph.sample_neighbor(src, edge_types, 1, rng=rng)
        pos = np.where(mask[:, 0], nbr[:, 0], src)
        negs = graph.sample_node(batch_size * num_negs, neg_type, rng=rng)
        return (flow.query(src), flow.query(pos), flow.query(negs))

    return fn


def _padded_chunks(ids: np.ndarray, batch_size: int) -> Iterator[np.ndarray]:
    """Fixed-size id chunks; the last one pads by repeating its final id."""
    for i in range(0, len(ids), batch_size):
        chunk = ids[i : i + batch_size]
        if len(chunk) < batch_size:  # pad to keep shapes static
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - len(chunk))]
            )
        yield chunk


def read_sample_ids(path: str, column: int = 0) -> np.ndarray:
    """u64 root ids from a local comma-separated sample file (one sample a
    line)."""
    with open(path, "r", encoding="utf-8") as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return np.asarray([np.uint64(r[column]) for r in rows], dtype=np.uint64)


def sample_file_batches(
    flow, path: str, batch_size: int, epochs: int = 1, column: int = 0
) -> Iterator[tuple]:
    """Training source over a sample file: padded fixed-size batches of
    its `column` ids for `epochs` passes (the last batch repeats its
    final id; `id_batches(flow, read_sample_ids(path), ...)` identifies
    the padding for exact evaluation)."""
    ids = read_sample_ids(path, column)
    for _ in range(epochs):
        for chunk in _padded_chunks(ids, batch_size):
            yield (flow.query(chunk),)


def id_batches(
    flow, ids: np.ndarray, batch_size: int
) -> tuple[Iterator[tuple], Iterator[np.ndarray]]:
    """Fixed-id evaluation/inference source: (batches, the id chunks each
    batch's leading rows belong to); the last chunk is padded."""
    ids = np.asarray(ids, dtype=np.uint64)

    def batches():
        for chunk in _padded_chunks(ids, batch_size):
            yield (flow.query(chunk),)

    def id_chunks():
        for i in range(0, len(ids), batch_size):
            yield ids[i : i + batch_size]

    return batches(), id_chunks()
