from repro_torch.configs.registry import ARCHS, get_arch
