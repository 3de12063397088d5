"""Models of the JAX package's zoo: the decoder-only LMs (`transformer`),
dense and MoE (`moe`, serving), BST (`bst`, serving), the four GNNs
(`gnn`, forward) and their building blocks (`layers`). Training waits for
ROADMAP A16."""
