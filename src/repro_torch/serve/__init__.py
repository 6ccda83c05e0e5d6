from repro_torch.serve.engine import GenerateResult, generate  # noqa: F401
