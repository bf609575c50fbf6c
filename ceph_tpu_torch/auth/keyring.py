"""Entity keyring: names, secrets, caps.

Python-native equivalent of the reference's key management (reference
``src/auth/`` — CephX tickets over per-entity secrets held in the
monitor's KeyServer, ``auth/cephx/CephxKeyServer.h``; the keyring FILE
format of ``src/auth/KeyRing.cc``).  Scope note: the transport-level
shared-secret handshake lives in the messenger
(``auth_cluster_required=cephx``, msg/messenger.py _auth_exchange);
this module is the *entity database* behind ``ceph auth ...`` commands
— get-or-create/get/ls/del with caps — persisted by the monitor.

Keyring text round-trips the reference's INI-ish format::

    [client.admin]
        key = <base64>
        caps mon = "allow *"
        caps osd = "allow *"
"""
from __future__ import annotations

import base64
import os
import re
from typing import Dict, List, Optional


def generate_key() -> str:
    """reference CryptoKey::create — random secret, base64 text."""
    return base64.b64encode(os.urandom(16)).decode()


class Entity:
    def __init__(self, name: str, key: str,
                 caps: Optional[Dict[str, str]] = None):
        self.name = name
        self.key = key
        self.caps = dict(caps or {})

    def dump(self) -> Dict:
        return {"entity": self.name, "key": self.key,
                "caps": dict(self.caps)}


class Keyring:
    """reference KeyRing + the mon's KeyServerData."""

    def __init__(self) -> None:
        self.entities: Dict[str, Entity] = {}

    # -- management ----------------------------------------------------
    def get_or_create(self, name: str,
                      caps: Optional[Dict[str, str]] = None) -> Entity:
        ent = self.entities.get(name)
        if ent is None:
            ent = Entity(name, generate_key(), caps)
            self.entities[name] = ent
        elif caps:
            ent.caps.update(caps)
        return ent

    def get(self, name: str) -> Optional[Entity]:
        return self.entities.get(name)

    def remove(self, name: str) -> bool:
        return self.entities.pop(name, None) is not None

    def names(self) -> List[str]:
        return sorted(self.entities)

    # -- file format (reference KeyRing.cc encode_plaintext/parse) -----
    def to_text(self, only: Optional[str] = None) -> str:
        lines: List[str] = []
        for name in self.names():
            if only is not None and name != only:
                continue
            ent = self.entities[name]
            lines.append(f"[{name}]")
            lines.append(f"\tkey = {ent.key}")
            for svc in sorted(ent.caps):
                lines.append(f'\tcaps {svc} = "{ent.caps[svc]}"')
        return "\n".join(lines) + ("\n" if lines else "")

    @classmethod
    def from_text(cls, text: str) -> "Keyring":
        kr = cls()
        current: Optional[Entity] = None
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            m = re.fullmatch(r"\[([^\]]+)\]", line)
            if m:
                current = Entity(m.group(1), "")
                kr.entities[current.name] = current
                continue
            if current is None:
                raise ValueError(f"key material before section: {line!r}")
            m = re.fullmatch(r"key\s*=\s*(\S+)", line)
            if m:
                current.key = m.group(1)
                continue
            m = re.fullmatch(r'caps\s+(\S+)\s*=\s*"([^"]*)"', line)
            if m:
                current.caps[m.group(1)] = m.group(2)
                continue
            raise ValueError(f"unparseable keyring line: {line!r}")
        return kr

    # -- wire/persistence ----------------------------------------------
    def dump(self) -> List[Dict]:
        return [self.entities[n].dump() for n in self.names()]

    @classmethod
    def load(cls, rows: List[Dict]) -> "Keyring":
        kr = cls()
        for row in rows:
            kr.entities[row["entity"]] = Entity(
                row["entity"], row["key"], row.get("caps"))
        return kr
