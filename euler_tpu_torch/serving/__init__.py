from euler_tpu_torch.serving.runtime import DEFAULT_BUCKETS, InferenceRuntime  # noqa: F401
