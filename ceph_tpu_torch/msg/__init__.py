"""Messenger layer (reference src/msg/, src/messages/).

- message: Message base, type registry, CRC frame codec
- messages: the typed message catalog the daemons exchange
- messenger: async TCP Messenger with lossless reconnect/resend,
  dispatcher fan-out, and socket fault injection
"""
from .message import Message, encode_frame
from .messenger import Connection, Dispatcher, Messenger
from . import messages

__all__ = ["Message", "encode_frame", "Connection", "Dispatcher",
           "Messenger", "messages"]
