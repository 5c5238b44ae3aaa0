from euler_tpu_torch.nn.base_gnn import GNNNet  # noqa: F401
