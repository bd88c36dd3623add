"""Model layer: Node2Vec (the port of ``muninn_tpu.models``' Node2Vec; the
embedding and chat registry is not ported yet)."""

from muninn_tpu_torch.models.node2vec import node2vec_train

__all__ = ["node2vec_train"]
