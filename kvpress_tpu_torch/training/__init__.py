from .kvzap import (
    KVzipScoreCollector,
    collect_scores,
    fit_mlp,
    init_mlp_surrogate,
    repeat_prompt_tokenization,
    train_linear,
    train_mlp,
)

__all__ = [
    "KVzipScoreCollector",
    "collect_scores",
    "fit_mlp",
    "init_mlp_surrogate",
    "repeat_prompt_tokenization",
    "train_linear",
    "train_mlp",
]
