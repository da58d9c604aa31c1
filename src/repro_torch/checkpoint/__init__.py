"""Checkpoints (counterpart of ``repro.checkpoint``): the npz pytree
checkpoint and the bucket-granular sweep checkpoint behind
``api.run(spec, resume=dir)``, in the reference's file formats."""
from .checkpoint import load_checkpoint, save_checkpoint
from .sweep import SweepCheckpoint, decode_tree, encode_tree

__all__ = ["load_checkpoint", "save_checkpoint", "SweepCheckpoint",
           "encode_tree", "decode_tree"]
