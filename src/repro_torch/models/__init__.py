"""Models of the JAX package's zoo ported so far: the dense decoder-only
LMs (`transformer`), BST (`bst`, serving) and their building blocks
(`layers`). The MoE and GNN models wait for ROADMAP A16."""
