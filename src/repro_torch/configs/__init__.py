from repro_torch.configs.registry import ARCH_IDS, get_arch  # noqa: F401
