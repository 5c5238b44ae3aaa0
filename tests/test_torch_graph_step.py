"""euler_tpu_torch's captured training step, the parts the CPU reaches:
the launch accounting of a capture and its replays, and the step inputs'
trip through static buffers (the CUDA graph itself runs only on a card;
`chip_smoke.py` holds its replays against eager steps there).
"""

import dataclasses
import threading

import numpy as np
import torch

from euler_tpu_torch import ops
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.dataflow import SageDataFlow, to_device
from euler_tpu_torch.estimator.graph_step import signature, tensor_leaves, with_leaves
from euler_tpu_torch.ops import _build

torch.set_num_threads(1)


def test_capture_counts_no_launch_and_replays_add_the_captured_ones():
    before = ops.launch_counts()
    with _build.uncounted_launches() as captured:
        for name in ("gather_weighted_sum",) * 3 + ("gather_weighted_sum_dx",):
            _build.count_launch(name)
    assert ops.launch_counts() == before
    assert {k: n for k, n in captured.items() if n} == {
        "gather_weighted_sum": 3, "gather_weighted_sum_dx": 1}
    for _ in range(5):
        _build.add_launches(captured)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "gather_weighted_sum": 15, "gather_weighted_sum_dx": 5}


def test_capture_takes_launches_recorded_on_its_stream_by_another_thread(monkeypatch):
    """A captured backward runs on autograd's own thread, on the capture's
    stream: its launches go to the capture, not to the counts; a thread
    launching on another stream meanwhile is counted as usual. (The CPU
    build has no streams: the two torch.cuda calls the accounting reads
    are stood in for.)"""

    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    local = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(local, "stream", 0) == 7)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream(getattr(local, "stream", 0)))

    def launch(stream, n):
        local.stream = stream
        for _ in range(n):
            _build.count_launch("gather_weighted_sum_dx")

    before = ops.launch_counts()
    with _build.uncounted_launches(Stream(7)) as captured:
        for stream, n in ((7, 3), (0, 5)):
            t = threading.Thread(target=launch, args=(stream, n))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    after = ops.launch_counts()
    assert captured["gather_weighted_sum_dx"] == 3
    assert after["gather_weighted_sum_dx"] - before["gather_weighted_sum_dx"] == 5
    assert not _build._STREAM_CAPTURES  # the capture's stream is released


def test_step_inputs_round_trip_through_static_buffers():
    """A host batch on the device and a device flow's draws: their
    tensors, in order, into buffers and back into the same structure;
    the signature sees shapes, dtypes and the static fields only."""
    g = random_graph(num_nodes=60, out_degree=3, feat_dim=4, seed=1)
    flow = SageDataFlow(g, ["feat"], fanouts=[3, 2], label_feature="label",
                        rng=np.random.default_rng(0))
    batch = (to_device(flow.query(np.arange(1, 6, dtype=np.uint64)), "cpu"),)
    draws = (torch.arange(5, dtype=torch.int32), (torch.rand(5, 3), torch.rand(15, 2)))
    for x in (batch, draws):
        leaves = tensor_leaves(x)
        static = [torch.empty_like(t) for t in leaves]
        y = with_leaves(x, iter(static))
        assert [id(t) for t in tensor_leaves(y)] == [id(t) for t in static]
        assert signature(y) == signature(x)
        for s, t in zip(static, leaves):
            s.copy_(t)
        assert all(torch.equal(a, b) for a, b in zip(tensor_leaves(y), leaves))
    (b,) = batch
    # feats, masks, blocks, root, labels, and the hop ids, which a
    # captured step must take as inputs like the rest of the batch
    assert len(tensor_leaves(batch)) == 3 + 3 + 2 * 4 + 2 + 3
    assert all(h.dtype == torch.int32 for h in b.hop_ids)
    assert signature(batch) != signature((dataclasses.replace(b, feats=b.feats[:2]),))
    assert signature(draws) != signature((draws[0], (draws[1][0], torch.rand(15, 3))))
