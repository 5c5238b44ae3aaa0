from euler_tpu_torch.layers.conv import (  # noqa: F401
    APPNPConv,
    ARMAConv,
    Conv,
    GATConv,
    GCNConv,
    GraphConv,
    SAGEConv,
    SGCNConv,
    TAGConv,
    degrees,
)

# the JAX package's names (euler_tpu/layers/__init__.py); the other convs
# wait for ROADMAP queue 1 item 4's second half
CONVS = {
    "sage": SAGEConv,
    "gcn": GCNConv,
    "gat": GATConv,
    "graph": GraphConv,
    "appnp": APPNPConv,
    "sgcn": SGCNConv,
    "tagcn": TAGConv,
    "arma": ARMAConv,
}


def get_conv(name: str):
    if name not in CONVS:
        raise KeyError(f"unknown conv {name!r}; have {sorted(CONVS)}")
    return CONVS[name]
