"""The GNN family: segment message passing (``common``), GAT, GatedGCN,
SchNet, and EquiformerV2 with the constant-J SO(3) rotations (``so3``)."""
