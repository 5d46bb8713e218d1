from repro_torch.data.pipeline import DataPipeline, make_batch  # noqa: F401
