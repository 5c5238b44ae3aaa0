from euler_tpu_torch.layers.conv import (  # noqa: F401
    AGNNConv,
    APPNPConv,
    ARMAConv,
    Conv,
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
    degrees,
)

# the JAX package's names (euler_tpu/layers/__init__.py); RelationConv,
# which takes per-relation blocks, is not among them (RGCNSupervised builds it)
CONVS = {
    "gcn": GCNConv,
    "sage": SAGEConv,
    "gat": GATConv,
    "gin": GINConv,
    "graph": GraphConv,
    "appnp": APPNPConv,
    "sgcn": SGCNConv,
    "tagcn": TAGConv,
    "agnn": AGNNConv,
    "arma": ARMAConv,
    "dna": DNAConv,
    "gated": GatedGraphConv,
    "geniepath": GeniePathConv,
    "lgcn": LGCNConv,
}


def get_conv(name: str):
    if name not in CONVS:
        raise KeyError(f"unknown conv {name!r}; have {sorted(CONVS)}")
    return CONVS[name]
