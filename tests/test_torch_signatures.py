"""euler_tpu_torch constructors (and `Graph.load` and
`InferenceRuntime.swap`) take the JAX package's parameters in its order
and under its names, so a caller's positional arguments mean the
same thing in both packages. Port-only parameters (`device`) are
keyword-only. The one deliberate difference: the torch modules take their
input width `in_dim` first, where flax infers it at init.
"""

import inspect

import pytest
import torch

from euler_tpu.dataflow import DeviceSageFlow as JaxDeviceSageFlow
from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullNeighborDataFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.dataflow.base import DataFlow as JaxDataFlow
from euler_tpu.estimator import DeviceFeatureCache as JaxDeviceFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.graph.native import NativeGraphStore as JaxNativeGraphStore
from euler_tpu.layers import SAGEConv as JaxSAGEConv
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGESupervised
from euler_tpu.nn import GNNNet as JaxGNNNet
from euler_tpu.serving import InferenceRuntime as JaxInferenceRuntime
from euler_tpu.serving import MicroBatcher as JaxMicroBatcher
from euler_tpu.serving import ModelServer as JaxModelServer
from euler_tpu.serving import ServingClient as JaxServingClient
from euler_tpu.serving import ServingRouter as JaxServingRouter
from euler_tpu.serving import TenantQuota as JaxTenantQuota
from euler_tpu_torch.dataflow import DeviceSageFlow, FullNeighborDataFlow, SageDataFlow
from euler_tpu_torch.dataflow.base import DataFlow
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator
from euler_tpu_torch.graph import Graph
from euler_tpu_torch.graph.native import NativeGraphStore
from euler_tpu_torch.layers import SAGEConv
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.nn import GNNNet
from euler_tpu_torch.serving import (
    InferenceRuntime,
    MicroBatcher,
    ModelServer,
    ServingClient,
    ServingRouter,
    TenantQuota,
)

torch.set_num_threads(1)

PAIRS = [
    (DataFlow, JaxDataFlow),
    (SageDataFlow, JaxSageDataFlow),
    (FullNeighborDataFlow, JaxFullNeighborDataFlow),
    (InferenceRuntime, JaxInferenceRuntime),
    (InferenceRuntime.swap, JaxInferenceRuntime.swap),
    (ModelServer, JaxModelServer),
    (MicroBatcher, JaxMicroBatcher),
    (TenantQuota, JaxTenantQuota),
    (ServingClient, JaxServingClient),
    (ServingRouter, JaxServingRouter),
    (Estimator, JaxEstimator),
    (DeviceFeatureCache, JaxDeviceFeatureCache),
    (DeviceSageFlow, JaxDeviceSageFlow),
    (SAGEConv, JaxSAGEConv),
    (GNNNet, JaxGNNNet),
    (GraphSAGESupervised, JaxGraphSAGESupervised),
    (Graph.load, JaxGraph.load),
    (NativeGraphStore, JaxNativeGraphStore),
]
# the torch modules' input width, which flax infers at init
IN_DIM_FIRST = (SAGEConv, GNNNet, GraphSAGESupervised)
# flax.linen.Module's own dataclass fields
FLAX_FIELDS = ("parent", "name")


def _positional(cls, skip=()) -> list:
    params = inspect.signature(cls).parameters.values()
    return [p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.name not in skip]


@pytest.mark.parametrize("port,ref", PAIRS, ids=[p.__qualname__ for p, _ in PAIRS])
def test_positional_parameters_follow_the_reference(port, ref):
    got = _positional(port)
    if port in IN_DIM_FIRST:
        assert got[0] == "in_dim"
        got = got[1:]
    assert got == _positional(ref, skip=FLAX_FIELDS)
    keyword_only = [p.name for p in inspect.signature(port).parameters.values()
                    if p.kind == p.KEYWORD_ONLY]
    assert keyword_only in ([], ["device"])
