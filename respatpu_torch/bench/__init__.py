from . import synth

__all__ = ["synth"]
