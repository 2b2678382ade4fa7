"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBFs, cutoff 10."""
from repro_torch.models.gnn.schnet import SchNetConfig

ARCH_ID = "schnet"
FAMILY = "gnn"
MODEL = "schnet"


def full_config(d_feat=16, n_classes=1, edge_chunks=1) -> SchNetConfig:
    return SchNetConfig(name=ARCH_ID, n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0, n_out=n_classes)


def reduced_config(d_feat=16, n_classes=1) -> SchNetConfig:
    return SchNetConfig(name=ARCH_ID + "-reduced", n_interactions=2,
                        d_hidden=16, n_rbf=32, cutoff=5.0, n_out=n_classes)
