from repro_torch.utils.hashing import fingerprint_string, mix64, splitmix64
