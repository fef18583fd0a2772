"""Weak-supervision-weighted contrastive fine-tuning of the CLIP towers on
one device (the port's ``tpualign.train``): the weak scores (lexical
overlap + bbox proximity) weight each pair of a symmetric CLIP contrastive
loss, so the towers fine-tune on the noisy manual corpus itself.
"""

from tpualign_torch.train.loss import clip_contrastive_loss  # noqa: F401
from tpualign_torch.train.step import TrainState, create_train_state, train_step  # noqa: F401
