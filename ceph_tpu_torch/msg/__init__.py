"""Messenger layer (reference src/msg/, src/messages/).

- message: Message base, type registry, CRC frame codec
- messages: the typed message catalog the daemons exchange

The socket Messenger is not ported yet; in-process hosts carry frames
through encode_frame_parts and decode_frame_body.
"""
from .message import Message, encode_frame
from . import messages

__all__ = ["Message", "encode_frame", "messages"]
