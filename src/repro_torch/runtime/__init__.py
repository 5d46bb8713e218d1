from repro_torch.runtime.driver import FaultInjector, TrainDriver  # noqa: F401
