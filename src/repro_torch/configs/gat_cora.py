"""gat-cora [arXiv:1710.10903]: 2 layers, 8 hidden x 8 heads, attention agg."""
from repro_torch.models.gnn.gat import GATConfig

ARCH_ID = "gat-cora"
FAMILY = "gnn"
MODEL = "gat"


def full_config(d_feat=1433, n_classes=7, edge_chunks=1) -> GATConfig:
    return GATConfig(name=ARCH_ID, n_layers=2, d_hidden=8, n_heads=8,
                     d_in=d_feat, n_classes=n_classes)


def reduced_config(d_feat=64, n_classes=7) -> GATConfig:
    return GATConfig(name=ARCH_ID + "-reduced", n_layers=2, d_hidden=4,
                     n_heads=2, d_in=d_feat, n_classes=n_classes)
