"""equiformer-v2 [arXiv:2306.12059]: 12 blocks, C=128, l_max=6, m_max=2,
8 heads, SO(2) eSCN convolutions."""
from repro_torch.models.gnn.equiformer import EquiformerConfig

ARCH_ID = "equiformer-v2"
FAMILY = "gnn"
MODEL = "equiformer"


def full_config(d_feat=16, n_classes=1, edge_chunks=1) -> EquiformerConfig:
    return EquiformerConfig(
        name=ARCH_ID, n_layers=12, channels=128, l_max=6, m_max=2, n_heads=8,
        n_out=n_classes, edge_chunks=edge_chunks,
    )


def reduced_config(d_feat=16, n_classes=1) -> EquiformerConfig:
    return EquiformerConfig(
        name=ARCH_ID + "-reduced", n_layers=2, channels=16, l_max=3, m_max=2,
        n_heads=4, n_out=n_classes, edge_chunks=2,
    )
