"""gatedgcn [arXiv:2003.00982]: 16 layers, d=70, gated edge aggregation."""
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig

ARCH_ID = "gatedgcn"
FAMILY = "gnn"
MODEL = "gatedgcn"


def full_config(d_feat=1433, n_classes=7, edge_chunks=1) -> GatedGCNConfig:
    return GatedGCNConfig(name=ARCH_ID, n_layers=16, d_hidden=70,
                          d_in=d_feat, n_classes=n_classes)


def reduced_config(d_feat=64, n_classes=7) -> GatedGCNConfig:
    return GatedGCNConfig(name=ARCH_ID + "-reduced", n_layers=3, d_hidden=16,
                          d_in=d_feat, n_classes=n_classes)
