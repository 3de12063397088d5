"""Models of the JAX package's zoo ported so far: the dense decoder-only
LMs (`transformer`), BST (`bst`, serving), the four GNNs (`gnn`, forward)
and their building blocks (`layers`). The MoE models wait for ROADMAP
A16."""
