from repro_torch.utils.metrics import avg_f1_score, canonical_labels

__all__ = ["avg_f1_score", "canonical_labels"]
