from repro_torch.optim.local import LocalOpt, adam, momentum, sgd  # noqa: F401
