"""Models of the JAX package's zoo ported so far: the dense decoder-only
LMs (`transformer`) and their building blocks (`layers`). The MoE, GNN and
BST models wait for ROADMAP A16."""
