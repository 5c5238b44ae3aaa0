from euler_tpu_torch.layers.conv import Conv, SAGEConv, degrees  # noqa: F401

CONVS = {
    "sage": SAGEConv,
}


def get_conv(name: str):
    if name not in CONVS:
        raise KeyError(f"unknown conv {name!r}; have {sorted(CONVS)}")
    return CONVS[name]
