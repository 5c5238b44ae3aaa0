"""InferenceRuntime — a trained model as an online prediction function
(counterpart: euler_tpu/serving/runtime.py).

Loads a checkpoint into the model once, and serves `predict(node_ids) ->
embeddings`. Every request is padded to one of a small menu of batch
sizes (buckets), so only a few shapes ever run on the device; each row
of a padded batch depends only on that row's subgraph. The program a
bucket runs is the engine's `Estimator.embed_program()`, the one
`Estimator.infer` runs, so served rows are offline inference's rows bit
for bit. With a `DeviceFeatureCache` (and a rows-mode flow) a batch
carries int32 feature rows, and the cache hydrates them on the device:
the JAX package's production serving configuration.

Hot reload: the weights live in one immutable `_Engine` (an Estimator
with its model on the device); `swap()` builds and warms a NEW engine
off the dispatch path, then publishes it with one reference assignment.
Every predict() grabs the engine reference once at entry, so an
in-flight request — even a chunked one — runs start to finish on one
checkpoint.
"""

from __future__ import annotations

import copy
import threading

import numpy as np

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.estimator.estimator import Estimator, EstimatorConfig
from euler_tpu_torch.params import state_dict_from_leaves
from euler_tpu_torch.training.checkpoint import CheckpointStore

DEFAULT_BUCKETS = (8, 32, 128)


class _Engine:
    """One checkpoint's serving state: the Estimator holding the weights
    on the device, its embed program and the checkpoint's step (None for
    `params=`). Immutable after construction."""

    __slots__ = ("est", "embed", "step")

    def __init__(self, est, embed, step):
        self.est = est
        self.embed = embed
        self.step = step


class InferenceRuntime:
    """One model + checkpoint + dataflow, served on one device.

    model: a module with `embed(batch)` (its own weights are a template;
    each engine's Estimator holds a copy). cfg: an EstimatorConfig (its
    model_dir locates the checkpoint) or a model_dir string. params: a
    state_dict (e.g. from `params.from_flax`) that skips the checkpoint
    restore. feature_cache: a `DeviceFeatureCache` on the runtime's
    device, for a flow in feature_mode="rows"; every engine, a swapped
    one too, serves through it. `mesh` is not ported yet (ROADMAP queue 1
    item 6).

    Not thread-safe by design: `predict` is called from ONE dispatcher
    thread (the MicroBatcher's); direct callers must serialize (`lock`).
    `swap` is safe to call from any other thread while the dispatcher
    runs.
    """

    def __init__(
        self,
        model,
        flow,
        cfg=None,
        feature_cache=None,
        buckets=DEFAULT_BUCKETS,
        mesh=None,
        params=None,
        *,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "InferenceRuntime(mesh=) is not ported yet (ROADMAP queue 1 item 6)"
            )
        self.model = model
        self.flow = flow
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets!r}")
        self._feature_cache = feature_cache
        # serializes swap() callers and guards the _model_dir/_engine
        # publishes; the predict path never takes it
        self._swap_lock = threading.Lock()
        with self._swap_lock:
            self._model_dir = _model_dir(cfg)
            self._engine = self._build_engine(self._model_dir, params)
        # telemetry for the micro-batching proof: executed device batches
        # must undercut request count under concurrency
        self.device_batches = 0
        self._batches_lock = threading.Lock()
        self.reloads = 0
        self.lock = threading.Lock()  # guards direct multi-caller use

    def _build_engine(self, model_dir, params) -> _Engine:
        step = None
        if params is None:
            if model_dir is None:
                raise ValueError("need cfg= (or a model_dir) or params=")
            ckpt = CheckpointStore(model_dir).load()
            params = state_dict_from_leaves(self.model.state_dict(), ckpt["params"])
            step = ckpt["step"]
        # the engine never trains, so its Estimator needs no batches
        est = Estimator(copy.deepcopy(self.model), None,
                        EstimatorConfig(model_dir=model_dir) if model_dir else None,
                        feature_cache=self._feature_cache, init_params=params,
                        device=self.device)
        est.model.eval()
        return _Engine(est, est.embed_program(), step)

    @property
    def params(self) -> dict:
        return self._engine.est.model.state_dict()

    @property
    def _est(self) -> Estimator:
        """The live engine's Estimator."""
        return self._engine.est

    @property
    def _embed(self):
        """The live engine's embed program (`_est.embed_program()`)."""
        return self._engine.embed

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding n roots (n > max bucket → max bucket;
        predict then chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self) -> None:
        """Run every bucket once, so the first real request pays no
        kernel build or allocator growth."""
        eng = self._engine
        for b in self.buckets:
            self._predict_bucket(np.ones(b, np.uint64), b, eng)

    def poll_graph_epoch(self) -> bool:
        """Streaming-mutation handshake. Local in-process graphs swap
        their store references at publish and need no poll: always False."""
        return False

    def swap(self, cfg=None, params=None, warm: bool = True) -> dict:
        """Zero-downtime checkpoint hot reload from `cfg` (an
        EstimatorConfig or a model_dir string; default: re-read the
        current model_dir, picking up a newer complete checkpoint) or
        from a `params` state_dict. Only complete checkpoints are
        candidates (a torn `ckpt_<step>/` is never loaded). The new
        engine is built, its weights copied and every bucket warmed
        before the one-assignment publish; requests in flight finish on
        the engine they started on."""
        with self._swap_lock:
            new_dir = _model_dir(cfg) if cfg is not None else self._model_dir
            eng = self._build_engine(new_dir, params)
            warmed = []
            if warm:
                for b in self.buckets:
                    self._predict_bucket(np.ones(b, np.uint64), b, eng)
                    warmed.append(b)
            self._model_dir = new_dir
            self._engine = eng  # atomic publish: the swap itself
            self.reloads += 1
            return {
                "reloaded": True,
                "reloads": self.reloads,
                "warmed_buckets": warmed,
                "model_dir": new_dir,
            }

    def predict(self, node_ids) -> np.ndarray:
        """Embeddings for `node_ids` ([n, D] float32); pads each chunk to a
        bucket."""
        eng = self._engine  # one checkpoint per request, even chunked
        ids = np.asarray(node_ids, dtype=np.uint64).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty id list")
        top = self.buckets[-1]
        if len(ids) <= top:
            return self._predict_bucket(ids, self.bucket_for(len(ids)), eng)
        return np.concatenate(
            [
                self._predict_bucket(ids[lo : lo + top], top, eng)
                for lo in range(0, len(ids), top)
            ]
        )

    def _predict_bucket(self, ids: np.ndarray, bucket: int, eng: _Engine) -> np.ndarray:
        batch, n = self.flow.query_padded(ids, bucket)
        emb = eng.embed(batch)[:n].float().cpu().numpy()
        with self._batches_lock:
            self.device_batches += 1
        return emb


def _model_dir(cfg) -> str | None:
    """The model_dir of an EstimatorConfig, a model_dir string or None."""
    return cfg if cfg is None or isinstance(cfg, str) else cfg.model_dir
