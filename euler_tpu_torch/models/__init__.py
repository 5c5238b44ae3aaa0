from euler_tpu_torch.models.graphsage import GraphSAGESupervised  # noqa: F401
