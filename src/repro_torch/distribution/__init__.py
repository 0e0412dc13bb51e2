from repro_torch.distribution.pipeline import PipelineConfig, gpipe  # noqa: F401
