"""Knowledge-graph embedding models: TransE/H/R/D, DistMult, RotatE
(counterpart: euler_tpu/models/kg.py:26-362).

Entity and relation tables are `Embedding`s; scoring is batched vector
math. The Trans* variants train a margin ranking loss over corrupted
triples, DistMult and RotatE a logistic loss; the training metric is MRR
over the in-batch negatives. `kg_rank_eval` and `kg_ranking_metrics`
rank against every entity (the latter in the filtered setting).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.nn.encoders import Embedding, zeros_rows
from euler_tpu_torch.nn.metrics import mrr

VARIANTS = ("transe", "transh", "transr", "transd", "distmult", "rotate")


def _l2norm(x, dim=-1, eps=1e-12):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _eye_rows(dim: int, rd: int):
    """TransR's projection init: every row the flattened [dim, rd]
    identity, so step 0 scores as TransE."""
    eye = torch.eye(dim, rd, dtype=torch.float32).reshape(-1)

    def init(shape, generator=None):
        return eye.expand(shape).clone()

    return init


class TransX(nn.Module):
    """variant ∈ {transe, transh, transr, transd, distmult, rotate}.

    Batch: dict(h, r, t int32[B]; neg_h, neg_t int32[B, N]).
    """

    def __init__(
        self,
        num_entities: int,
        num_relations: int,
        dim: int = 100,
        rel_dim: int = 0,
        variant: str = "transe",
        margin: float = 1.0,
        norm_ord: int = 2,
    ):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown TransX variant {variant!r}; have {VARIANTS}")
        self.num_entities = int(num_entities)
        self.num_relations = int(num_relations)
        self.dim = int(dim)
        self.rel_dim = int(rel_dim)
        self.variant = variant
        self.margin = float(margin)
        self.norm_ord = int(norm_ord)
        rd = self.rel_dim or self.dim
        self.entity = Embedding(self.num_entities + 1, self.dim)
        if variant == "rotate":
            self.relation = Embedding(self.num_relations + 1, self.dim // 2)
        else:
            self.relation = Embedding(self.num_relations + 1, rd)
        if variant == "transh":
            self.norm_vec = Embedding(self.num_relations + 1, self.dim)
        elif variant == "transr":
            # identity-initialised projections: a warm-started TransR
            # scores as the trained TransE at step 0
            self.proj = Embedding(self.num_relations + 1, self.dim * rd,
                                  row_init=_eye_rows(self.dim, rd))
        elif variant == "transd":
            # zero-initialised projection vectors: TransD starts as TransE
            self.ent_proj = Embedding(self.num_entities + 1, self.dim, row_init=zeros_rows)
            self.rel_proj = Embedding(self.num_relations + 1, rd, row_init=zeros_rows)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.entity(ids)

    # -- scoring ---------------------------------------------------------

    def _project(self, e, e_ids, r_ids):
        """Entity → relation space, per variant."""
        rd = self.rel_dim or self.dim
        if self.variant == "transh":
            w = _l2norm(self.norm_vec(r_ids))
            w = w.reshape(e.shape)
            return e - torch.sum(w * e, dim=-1, keepdim=True) * w
        if self.variant == "transr":
            m = self.proj(r_ids).reshape(tuple(r_ids.shape) + (self.dim, rd))
            return torch.einsum("...d,...dk->...k", e, m)
        if self.variant == "transd":
            ep = self.ent_proj(e_ids)
            rp = self.rel_proj(r_ids)
            inner = torch.sum(ep * e, dim=-1, keepdim=True)
            pad = rd - self.dim
            base = e if pad <= 0 else F.pad(e, (0, pad))
            return base[..., :rd] + inner * rp
        return e

    def _score(self, h, r, t, h_ids, r_ids, t_ids):
        """Higher = more plausible."""
        if self.variant == "distmult":
            return torch.sum(h * r * t, dim=-1)
        if self.variant == "rotate":
            hr, hi = torch.chunk(h, 2, dim=-1)
            tr, ti = torch.chunk(t, 2, dim=-1)
            cr, ci = torch.cos(r), torch.sin(r)
            dr = hr * cr - hi * ci - tr
            di = hr * ci + hi * cr - ti
            return -torch.sum(torch.sqrt(dr**2 + di**2 + 1e-12), dim=-1)
        hp = self._project(h, h_ids, r_ids)
        tp = self._project(t, t_ids, r_ids)
        if self.variant == "transd":
            # entities normalised after the projection into relation space
            hp, tp = _l2norm(hp), _l2norm(tp)
        diff = hp + r - tp
        if self.norm_ord == 1:
            return -torch.sum(torch.abs(diff), dim=-1)
        return -torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)

    def score_triples(self, h_ids, r_ids, t_ids):
        h = self.entity(h_ids)
        t = self.entity(t_ids)
        r = self.relation(r_ids)
        if self.variant in ("transe", "transh", "transr"):
            # transr normalises before its identity-initialised projection
            h, t = _l2norm(h), _l2norm(t)
        if self.variant == "transd":
            r = _l2norm(r)
        return self._score(h, r, t, h_ids, r_ids, t_ids)

    # -- training --------------------------------------------------------

    def forward(self, batch: dict):
        h, r, t = batch["h"], batch["r"], batch["t"]
        neg_h, neg_t = batch["neg_h"], batch["neg_t"]
        b, n = neg_h.shape
        pos = self.score_triples(h, r, t)  # [B]
        r2 = r[:, None].expand(b, n)
        neg1 = self.score_triples(neg_h, r2, t[:, None].expand(b, n))
        neg2 = self.score_triples(h[:, None].expand(b, n), r2, neg_t)
        negs = torch.cat([neg1, neg2], dim=1)  # [B, 2N]
        if self.variant in ("distmult", "rotate"):
            loss = torch.mean(_softplus(-pos)) + torch.mean(_softplus(negs))
        else:
            loss = torch.mean(torch.relu(self.margin + negs - pos[:, None]))
        return self.entity(h), loss, "mrr", mrr(pos, negs)


def transx_warm_start(model, trained_params, example_batch=None, seed: int = 0):
    """Warm-start params (a state_dict) for a projection variant from a
    trained sibling's: a seeded init of `model` (`params.init_like_flax`)
    with the entity and relation tables of `trained_params` (a state_dict
    or a flax tree), the projections at their identity or zero init —
    TransR/TransD then score exactly as the trained TransE at step 0.
    `example_batch` (which flax's init needs) is accepted for the
    signature."""
    from euler_tpu_torch.params import from_flax, init_like_flax

    fresh = copy.deepcopy(model).cpu()
    sd = {k: v.clone() for k, v in
          init_like_flax(fresh, torch.Generator().manual_seed(seed)).items()}
    if "params" in trained_params:  # a flax tree
        trained_params = from_flax(trained_params)
    for name in ("entity.table", "relation.table"):
        sd[name] = torch.as_tensor(trained_params[name]).detach().to("cpu", torch.float32).clone()
    return sd


def _to32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int64).astype(np.int32)


def kg_batches(graph, batch_size: int, num_negs: int = 8, edge_type: int = -1, rng=None):
    """Triple source: sampled edges (h=src, r=type, t=dst) + corrupted
    heads/tails drawn from the global node sampler."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        e = graph.sample_edge(batch_size, edge_type, rng=rng)
        negs = graph.sample_node(batch_size * num_negs * 2, -1, rng=rng)
        negs = _to32(negs).reshape(2, batch_size, num_negs)
        return (
            {
                "h": _to32(e[:, 0]),
                "r": _to32(e[:, 2]),
                "t": _to32(e[:, 1]),
                "neg_h": negs[0],
                "neg_t": negs[1],
            },
        )

    return fn


def _scoring_model(model, params):
    """`model` itself, or a copy holding `params` (a state_dict)."""
    if params is None:
        return model
    m = copy.deepcopy(model)
    m.load_state_dict(params)
    return m


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def kg_ranking_metrics(
    model,
    params,
    triples: np.ndarray,
    num_entities: int,
    filter_triples: np.ndarray | None = None,
    batch: int = 64,
    sides: tuple = ("head", "tail"),
):
    """Full-ranking evaluation in the FILTERED setting (Bordes et al.):
    MRR, Hits@1/10 and MeanRank over head- and tail-corrupted triples,
    every OTHER known-true triple removed from the candidates (the raw
    setting when `filter_triples` is None). triples / filter_triples:
    int [M, 3] (h, r, t), entities 1-based. params: a state_dict, or None
    for the model's own. Deterministic."""
    m = _scoring_model(model, params)
    dev = _device_of(m)
    triples = np.asarray(triples, np.int64)
    all_ents = torch.arange(1, num_entities + 1, dtype=torch.int32, device=dev)

    def scores_for(h, r, t, corrupt_head):
        pos = m.score_triples(h, r, t)
        b = h.shape[0]
        ents = all_ents[None, :].expand(b, num_entities)
        rb = r[:, None].expand(ents.shape)
        fixed = (t if corrupt_head else h)[:, None].expand(ents.shape)
        if corrupt_head:
            return pos, m.score_triples(ents, rb, fixed)
        return pos, m.score_triples(fixed, rb, ents)

    known = None
    if filter_triples is not None:
        known = np.unique(_triple_keys(np.asarray(filter_triples, np.int64), num_entities))
    ranks = []
    ent_range = np.arange(1, num_entities + 1, dtype=np.int64)
    with torch.inference_mode():
        for side in sides:
            corrupt_head = side == "head"
            for i in range(0, len(triples), batch):
                chunk = triples[i:i + batch]
                h, r, t = (torch.as_tensor(chunk[:, j].astype(np.int32), device=dev)
                           for j in range(3))
                pos, negs = scores_for(h, r, t, corrupt_head)
                pos = pos.cpu().numpy().astype(np.float64)
                negs = negs.cpu().numpy().astype(np.float64)
                beat = negs > pos[:, None]
                if known is not None:
                    b = len(chunk)
                    if corrupt_head:
                        cand = np.stack([
                            np.broadcast_to(ent_range, (b, num_entities)),
                            np.broadcast_to(chunk[:, 1:2], (b, num_entities)),
                            np.broadcast_to(chunk[:, 2:3], (b, num_entities)),
                        ], axis=-1)
                    else:
                        cand = np.stack([
                            np.broadcast_to(chunk[:, 0:1], (b, num_entities)),
                            np.broadcast_to(chunk[:, 1:2], (b, num_entities)),
                            np.broadcast_to(ent_range, (b, num_entities)),
                        ], axis=-1)
                    is_known = np.isin(
                        _triple_keys(cand.reshape(-1, 3), num_entities), known
                    ).reshape(b, num_entities)
                    beat &= ~is_known
                ranks.append(1 + beat.sum(axis=1))
    ranks = np.concatenate(ranks).astype(np.float64)
    return {
        "mean_rank": float(ranks.mean()),
        "mrr": float((1.0 / ranks).mean()),
        "hit@1": float((ranks <= 1).mean()),
        "hit@10": float((ranks <= 10).mean()),
        "filtered": filter_triples is not None,
        "num_ranks": int(len(ranks)),
    }


_REL_BASE = np.int64(1) << 20  # relation-id radix of the triple key


def _triple_keys(triples: np.ndarray, num_entities: int) -> np.ndarray:
    """Collision-free int64 key per (h, r, t) row (1-based entities
    bounded by num_entities, relations by 2^20)."""
    t = np.asarray(triples, np.int64)
    ent_base = np.int64(num_entities + 2)
    return (t[:, 0] * ent_base + t[:, 2]) * _REL_BASE + t[:, 1]


def kg_rank_ranks(model, params, triples: np.ndarray, num_entities: int,
                  batch: int = 64) -> np.ndarray:
    """The tail ranks `kg_rank_eval` averages: 1 + the entities scoring
    strictly above the true tail, per triple (f64 [M])."""
    m = _scoring_model(model, params)
    dev = _device_of(m)
    all_ents = torch.arange(1, num_entities + 1, dtype=torch.int32, device=dev)
    ranks = []
    with torch.inference_mode():
        for i in range(0, len(triples), batch):
            chunk = np.asarray(triples[i:i + batch])
            h, r, t = (torch.as_tensor(chunk[:, j].astype(np.int32), device=dev)
                       for j in range(3))
            pos = m.score_triples(h, r, t)
            b = h.shape[0]
            neg_t = m.score_triples(
                h[:, None].expand(b, num_entities),
                r[:, None].expand(b, num_entities),
                all_ents[None, :].expand(b, num_entities),
            )
            ranks.append((1 + (neg_t > pos[:, None]).sum(dim=1, dtype=torch.int32)).cpu().numpy())
    return np.concatenate(ranks).astype(np.float64)


def kg_rank_eval(model, params, triples: np.ndarray, num_entities: int, batch: int = 64):
    """Full-ranking eval: MeanRank / MRR / Hit@10 of each triple's tail
    against ALL entities. triples: int32 [M, 3] (h, r, t); params: a
    state_dict, or None for the model's own."""
    ranks = kg_rank_ranks(model, params, triples, num_entities, batch)
    return {
        "mean_rank": float(ranks.mean()),
        "mrr": float((1.0 / ranks).mean()),
        "hit@10": float((ranks <= 10).mean()),
    }
