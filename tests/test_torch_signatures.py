"""euler_tpu_torch constructors (and `Graph.load`, `InferenceRuntime.swap`
and the batch sources, walks, KG evaluations and graph builders of the
link-prediction families, the graph-label queries and the mutag
stand-in, the layer-wise, relation and auto-encoder families' flows,
batches and models, the ScalableGNN family and its HistoryTable, the
encoders, the aggregators and the embedding-table functions) take the JAX package's parameters in its order
and under its names, so a caller's positional arguments mean the
same thing in both packages. Port-only parameters (`device`) are
keyword-only. The one deliberate difference: the torch modules take their
input width `in_dim` first, where flax infers it at init.
"""

import inspect

import flax.linen
import pytest
import torch

from euler_tpu.dataflow import DeviceEdgeFlow as JaxDeviceEdgeFlow
from euler_tpu.dataflow import DeviceKGFlow as JaxDeviceKGFlow
from euler_tpu.dataflow import DeviceSageFlow as JaxDeviceSageFlow
from euler_tpu.dataflow import DeviceUnsupSageFlow as JaxDeviceUnsupSageFlow
from euler_tpu.dataflow import DeviceWalkFlow as JaxDeviceWalkFlow
from euler_tpu.dataflow import DeviceDgiFlow as JaxDeviceDgiFlow
from euler_tpu.dataflow import DeviceGaeFlow as JaxDeviceGaeFlow
from euler_tpu.dataflow import DeviceLayerwiseFlow as JaxDeviceLayerwiseFlow
from euler_tpu.dataflow import DeviceRelationFlow as JaxDeviceRelationFlow
from euler_tpu.dataflow import LayerwiseDataFlow as JaxLayerwiseDataFlow
from euler_tpu.dataflow import RelationDataFlow as JaxRelationDataFlow
from euler_tpu.dataflow.layerwise import LayerwiseBatch as JaxLayerwiseBatch
from euler_tpu.dataflow.relation import RelMiniBatch as JaxRelMiniBatch
from euler_tpu.graph.store import layerwise_from_full as jax_layerwise_from_full
from euler_tpu.layers import RelationConv as JaxRelationConv
from euler_tpu.models import DGI as JaxDGI
from euler_tpu.models import GAE as JaxGAE
from euler_tpu.models import LayerwiseGCN as JaxLayerwiseGCN
from euler_tpu.models import RGCNSupervised as JaxRGCNSupervised
from euler_tpu.models import dgi_batches as jax_dgi_batches
from euler_tpu.models import gae_batches as jax_gae_batches
from euler_tpu.dataflow.walk import gen_pair as jax_gen_pair
from euler_tpu.datasets import get_dataset as jax_get_dataset
from euler_tpu.datasets.quality import cora_like_json as jax_cora_like_json
from euler_tpu.datasets.quality import fb15k_like as jax_fb15k_like
from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullNeighborDataFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.dataflow.base import DataFlow as JaxDataFlow
from euler_tpu.estimator import DeviceFeatureCache as JaxDeviceFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import edge_batches as jax_edge_batches
from euler_tpu.estimator import unsupervised_batches as jax_unsupervised_batches
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.graph.builder import build_from_json as jax_build_from_json
from euler_tpu.graph.builder import convert_json as jax_convert_json
from euler_tpu.graph.native import NativeGraphStore as JaxNativeGraphStore
from euler_tpu.dataflow import FullGraphFlow as JaxFullGraphFlow
from euler_tpu.dataflow import DeviceWholeGraphFlow as JaxDeviceWholeGraphFlow
from euler_tpu.dataflow import WholeGraphDataFlow as JaxWholeGraphDataFlow
from euler_tpu.dataflow import graph_label_batches as jax_graph_label_batches
from euler_tpu.dataflow.whole import GraphBatch as JaxGraphBatch
from euler_tpu.datasets.quality import mutag_like_json as jax_mutag_like_json
from euler_tpu.layers import AGNNConv as JaxAGNNConv
from euler_tpu.layers import APPNPConv as JaxAPPNPConv
from euler_tpu.layers import ARMAConv as JaxARMAConv
from euler_tpu.layers import DNAConv as JaxDNAConv
from euler_tpu.layers import GATConv as JaxGATConv
from euler_tpu.layers import GatedGraphConv as JaxGatedGraphConv
from euler_tpu.layers import GCNConv as JaxGCNConv
from euler_tpu.layers import GeniePathConv as JaxGeniePathConv
from euler_tpu.layers import GINConv as JaxGINConv
from euler_tpu.layers import GraphConv as JaxGraphConv
from euler_tpu.layers import LGCNConv as JaxLGCNConv
from euler_tpu.layers import SAGEConv as JaxSAGEConv
from euler_tpu.layers import SGCNConv as JaxSGCNConv
from euler_tpu.layers import TAGConv as JaxTAGConv
from euler_tpu.models import GraphClassifier as JaxGraphClassifier
from euler_tpu.nn.pooling import AttentionPool as JaxAttentionPool
from euler_tpu.nn.pooling import Pooling as JaxPooling
from euler_tpu.nn.pooling import Set2SetPool as JaxSet2SetPool
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGESupervised
from euler_tpu.models import GraphSAGEUnsupervised as JaxGraphSAGEUnsupervised
from euler_tpu.models import SkipGramModel as JaxSkipGramModel
from euler_tpu.models import TransX as JaxTransX
from euler_tpu.models import deepwalk_batches as jax_deepwalk_batches
from euler_tpu.models import kg_batches as jax_kg_batches
from euler_tpu.models import kg_rank_eval as jax_kg_rank_eval
from euler_tpu.models import kg_ranking_metrics as jax_kg_ranking_metrics
from euler_tpu.models import line_batches as jax_line_batches
from euler_tpu.models import transx_warm_start as jax_transx_warm_start
from euler_tpu.nn import GNNNet as JaxGNNNet
from euler_tpu.nn import SuperviseModel as JaxSuperviseModel
from euler_tpu.nn import UnsuperviseModel as JaxUnsuperviseModel
from euler_tpu.nn.encoders import Embedding as JaxEmbedding
from euler_tpu.serving import InferenceRuntime as JaxInferenceRuntime
from euler_tpu.serving import MicroBatcher as JaxMicroBatcher
from euler_tpu.serving import ModelServer as JaxModelServer
from euler_tpu.serving import ServingClient as JaxServingClient
from euler_tpu.serving import ServingRouter as JaxServingRouter
from euler_tpu.serving import TenantQuota as JaxTenantQuota
from euler_tpu.models import ScalableGNN as JaxScalableGNN
from euler_tpu.models import ScalableTrainer as JaxScalableTrainer
from euler_tpu.nn import embedding as jax_embedding
from euler_tpu.nn import aggregators as jax_aggregators
from euler_tpu.nn.encoders import ShallowEncoder as JaxShallowEncoder
from euler_tpu.nn.encoders import SparseEmbedding as JaxSparseEmbedding
from euler_tpu.nn.history import HistoryTable as JaxHistoryTable
from euler_tpu_torch.models import ScalableGNN, ScalableTrainer
from euler_tpu_torch.nn import aggregators, embedding
from euler_tpu_torch.nn.encoders import ShallowEncoder, SparseEmbedding
from euler_tpu_torch.nn.history import HistoryTable
from euler_tpu_torch.dataflow import (
    DeviceDgiFlow,
    DeviceGaeFlow,
    DeviceLayerwiseFlow,
    DeviceRelationFlow,
    LayerwiseBatch,
    LayerwiseDataFlow,
    RelationDataFlow,
    RelMiniBatch,
    DeviceEdgeFlow,
    DeviceKGFlow,
    DeviceSageFlow,
    DeviceUnsupSageFlow,
    DeviceWalkFlow,
    DeviceWholeGraphFlow,
    FullGraphFlow,
    FullNeighborDataFlow,
    GraphBatch,
    SageDataFlow,
    WholeGraphDataFlow,
    gen_pair,
    graph_label_batches,
)
from euler_tpu_torch.datasets import cora_like_json, fb15k_like, get_dataset, mutag_like_json
from euler_tpu_torch.dataflow.base import DataFlow
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator
from euler_tpu_torch.estimator import edge_batches, unsupervised_batches
from euler_tpu_torch.graph import Graph, build_from_json, convert_json
from euler_tpu_torch.graph.native import NativeGraphStore
from euler_tpu_torch.graph.store import GraphStore, layerwise_from_full
from euler_tpu.graph.store import GraphStore as JaxGraphStore
from euler_tpu_torch.layers import (
    AGNNConv,
    APPNPConv,
    ARMAConv,
    DNAConv,
    GATConv,
    GatedGraphConv,
    GCNConv,
    GeniePathConv,
    GINConv,
    GraphConv,
    LGCNConv,
    RelationConv,
    SAGEConv,
    SGCNConv,
    TAGConv,
)
from euler_tpu_torch.models import (
    DGI,
    GAE,
    LayerwiseGCN,
    RGCNSupervised,
    dgi_batches,
    gae_batches,
    GraphClassifier,
    GraphSAGESupervised,
    GraphSAGEUnsupervised,
    SkipGramModel,
    TransX,
    deepwalk_batches,
    kg_batches,
    kg_rank_eval,
    kg_ranking_metrics,
    line_batches,
    transx_warm_start,
)
from euler_tpu_torch.nn import (
    AttentionPool,
    Embedding,
    GNNNet,
    Pooling,
    Set2SetPool,
    SuperviseModel,
    UnsuperviseModel,
)
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
    (GCNConv, JaxGCNConv),
    (GATConv, JaxGATConv),
    (GraphConv, JaxGraphConv),
    (APPNPConv, JaxAPPNPConv),
    (SGCNConv, JaxSGCNConv),
    (TAGConv, JaxTAGConv),
    (ARMAConv, JaxARMAConv),
    (GINConv, JaxGINConv),
    (AGNNConv, JaxAGNNConv),
    (DNAConv, JaxDNAConv),
    (GatedGraphConv, JaxGatedGraphConv),
    (GeniePathConv, JaxGeniePathConv),
    (LGCNConv, JaxLGCNConv),
    (Pooling, JaxPooling),
    (AttentionPool, JaxAttentionPool),
    (Set2SetPool, JaxSet2SetPool),
    (GraphClassifier, JaxGraphClassifier),
    (GraphBatch, JaxGraphBatch),
    (WholeGraphDataFlow, JaxWholeGraphDataFlow),
    (DeviceWholeGraphFlow, JaxDeviceWholeGraphFlow),
    (graph_label_batches, jax_graph_label_batches),
    (Graph.sample_graph_label, JaxGraph.sample_graph_label),
    (Graph.get_graph_by_label, JaxGraph.get_graph_by_label),
    (mutag_like_json, jax_mutag_like_json),
    (FullGraphFlow, JaxFullGraphFlow),
    (GNNNet, JaxGNNNet),
    (GraphSAGESupervised, JaxGraphSAGESupervised),
    (Graph.load, JaxGraph.load),
    (NativeGraphStore, JaxNativeGraphStore),
    (SuperviseModel, JaxSuperviseModel),
    (UnsuperviseModel, JaxUnsuperviseModel),
    (GraphSAGEUnsupervised, JaxGraphSAGEUnsupervised),
    (Embedding, JaxEmbedding),
    (SkipGramModel, JaxSkipGramModel),
    (TransX, JaxTransX),
    (DeviceUnsupSageFlow, JaxDeviceUnsupSageFlow),
    (DeviceWalkFlow, JaxDeviceWalkFlow),
    (DeviceEdgeFlow, JaxDeviceEdgeFlow),
    (DeviceKGFlow, JaxDeviceKGFlow),
    (unsupervised_batches, jax_unsupervised_batches),
    (edge_batches, jax_edge_batches),
    (deepwalk_batches, jax_deepwalk_batches),
    (line_batches, jax_line_batches),
    (kg_batches, jax_kg_batches),
    (kg_rank_eval, jax_kg_rank_eval),
    (kg_ranking_metrics, jax_kg_ranking_metrics),
    (transx_warm_start, jax_transx_warm_start),
    (gen_pair, jax_gen_pair),
    (Graph.random_walk, JaxGraph.random_walk),
    (Graph.sample_edge, JaxGraph.sample_edge),
    (Graph.from_json, JaxGraph.from_json),
    (build_from_json, jax_build_from_json),
    (convert_json, jax_convert_json),
    (get_dataset, jax_get_dataset),
    (cora_like_json, jax_cora_like_json),
    (fb15k_like, jax_fb15k_like),
    (layerwise_from_full, jax_layerwise_from_full),
    (GraphStore.sample_neighbor_layerwise, JaxGraphStore.sample_neighbor_layerwise),
    (Graph.sample_neighbor_layerwise, JaxGraph.sample_neighbor_layerwise),
    (NativeGraphStore.sample_neighbor_layerwise, JaxNativeGraphStore.sample_neighbor_layerwise),
    (LayerwiseDataFlow, JaxLayerwiseDataFlow),
    (RelationDataFlow, JaxRelationDataFlow),
    (LayerwiseBatch, JaxLayerwiseBatch),
    (RelMiniBatch, JaxRelMiniBatch),
    (RelationConv, JaxRelationConv),
    (RGCNSupervised, JaxRGCNSupervised),
    (LayerwiseGCN, JaxLayerwiseGCN),
    (GAE, JaxGAE),
    (DGI, JaxDGI),
    (gae_batches, jax_gae_batches),
    (dgi_batches, jax_dgi_batches),
    (DeviceRelationFlow, JaxDeviceRelationFlow),
    (DeviceLayerwiseFlow, JaxDeviceLayerwiseFlow),
    (DeviceGaeFlow, JaxDeviceGaeFlow),
    (DeviceDgiFlow, JaxDeviceDgiFlow),
    (HistoryTable, JaxHistoryTable),
    (ScalableGNN, JaxScalableGNN),
    (ScalableTrainer, JaxScalableTrainer),
    (SparseEmbedding, JaxSparseEmbedding),
    (ShallowEncoder, JaxShallowEncoder),
    *((getattr(aggregators, n), getattr(jax_aggregators, n))
      for n in ("MeanAggregator", "GCNAggregator", "MeanPoolAggregator", "MaxPoolAggregator",
                "AttentionAggregator")),
    *((getattr(embedding, n), getattr(jax_embedding, n))
      for n in ("embedding_update", "embedding_add", "embedding_moving_average",
                "partitioned_lookup", "partitioned_update")),
]
# the torch modules' input width, which flax infers at init
IN_DIM_FIRST = (SAGEConv, GCNConv, GATConv, GraphConv, APPNPConv, SGCNConv, TAGConv, ARMAConv,
                GINConv, AGNNConv, DNAConv, GatedGraphConv, GeniePathConv, LGCNConv,
                Pooling, AttentionPool, Set2SetPool, GraphClassifier,
                GNNNet, GraphSAGESupervised, SuperviseModel, UnsuperviseModel,
                GraphSAGEUnsupervised, RelationConv, RGCNSupervised, LayerwiseGCN, GAE, DGI,
                ScalableGNN, ShallowEncoder, aggregators.MeanAggregator,
                aggregators.GCNAggregator, aggregators.MeanPoolAggregator,
                aggregators.MaxPoolAggregator, aggregators.AttentionAggregator)
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
    flax_module = isinstance(ref, type) and issubclass(ref, flax.linen.Module)
    assert got == _positional(ref, skip=FLAX_FIELDS if flax_module else ())
    keyword_only = [p.name for p in inspect.signature(port).parameters.values()
                    if p.kind == p.KEYWORD_ONLY]
    assert keyword_only in ([], ["device"])
