"""Models of the JAX package's zoo: the decoder-only LMs (`transformer`),
dense and MoE (`moe`), BST (`bst`), the four GNNs (`gnn`) and their
building blocks (`layers`), each differentiable for the train steps of
`train.steps`."""
