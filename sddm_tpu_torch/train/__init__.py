from .checkpoints import load_checkpoint, msgpack_restore

__all__ = ["load_checkpoint", "msgpack_restore"]
