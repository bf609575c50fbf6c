"""Locally-repairable layered code plugin (reference
src/erasure-code/lrc/ErasureCodeLrc.{h,cc} + ErasureCodePluginLrc.cc).

Each layer is described by a chunks map (D = data, c = coding, _ =
unused) plus a profile; the layer instantiates an *inner* plugin through
the shared registry (default jerasure/reed_sol_van) — so ``plugin=lrc``
with an inner ``plugin=gpu`` runs every layer on the card through kernel
B1 with zero LRC changes (the wiring the north star names; reference
ErasureCodeLrc.cc:215-247 layers_init).  A ``device`` key in the LRC
profile is passed on to every layer whose plugin is ``gpu``; without it
those layers mean CUDA, as the ``gpu`` plugin does.

Profile forms (reference semantics, same precedence):
  * k/m/l simple form — generates mapping + layers + crush steps
    (reference parse_kml, :293-397);
  * explicit ``mapping=`` + ``layers=[[map, profile], ...]`` JSON
    (tolerates trailing commas like json_spirit).

Decode walks layers in reverse, letting local layers repair cheaply and
feeding recovered chunks upward (reference decode_chunks :777-860);
_minimum_to_decode picks the cheapest covering layer set
(reference :566-735).
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Mapping, Set, Tuple

import numpy as np
import torch

from ..interface import (ErasureCode, ErasureCodeProfile,
                         ErasureCodeValidationError)
from ..registry import ErasureCodePlugin
from .. import registry as ecreg

DEFAULT_KML = "-1"


class Layer:
    def __init__(self, chunks_map: str):
        self.chunks_map = chunks_map
        self.data: List[int] = []
        self.coding: List[int] = []
        self.chunks: List[int] = []
        self.chunks_as_set: Set[int] = set()
        self.profile: ErasureCodeProfile = {}
        self.erasure_code = None


def _parse_layer_profile(spec) -> ErasureCodeProfile:
    """Accept a dict, a JSON-object string, a space-separated k=v string,
    or empty."""
    if isinstance(spec, dict):
        return {str(a): str(b) for a, b in spec.items()}
    if not isinstance(spec, str):
        raise ErasureCodeValidationError(
            f"layer profile must be string or object, got {type(spec)}")
    s = spec.strip()
    if not s:
        return {}
    if s.startswith("{"):
        return {str(a): str(b) for a, b in json.loads(s).items()}
    out = {}
    for tok in s.split():
        if "=" not in tok:
            raise ErasureCodeValidationError(
                f"cannot parse layer profile token {tok!r}")
        a, b = tok.split("=", 1)
        out[a] = b
    return out


def _json_loads_lenient(s: str):
    """json_spirit tolerates trailing commas; match it."""
    s = re.sub(r",\s*([\]\}])", r"\1", s)
    return json.loads(s)


class ErasureCodeLrc(ErasureCode):
    def __init__(self):
        super().__init__()
        self.layers: List[Layer] = []
        self.chunk_count_ = 0
        self.data_chunk_count_ = 0
        self.rule_root = "default"
        self.rule_device_class = ""
        # (op, type, n) steps (reference ErasureCodeLrc.h:67-76)
        self.rule_steps: List[Tuple[str, str, int]] = [
            ("chooseleaf", "host", 0)]

    # -- interface basics -------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count_

    def get_chunk_size(self, object_size: int) -> int:
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- init -------------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        # inner=<plugin> selects the default per-layer plugin (the
        # north-star wiring, BASELINE config 4: plugin=lrc inner=gpu
        # runs every layer on the card; a layer profile's own plugin=
        # still wins).  The reference reaches the same effect by writing
        # plugin= into each layer's profile (ErasureCodeLrc.cc:215-247
        # layers_init); the kml simple form needs this knob because it
        # generates the layer profiles itself.
        self.inner_plugin = profile.pop("inner", "jerasure")
        self.inner_device = profile.get("device")
        kml_used = self.parse_kml(profile)
        self.parse(profile)
        if "layers" not in profile:
            raise ErasureCodeValidationError(
                "could not find 'layers' in profile")
        description = _json_loads_lenient(profile["layers"])
        if not isinstance(description, list):
            raise ErasureCodeValidationError("layers must be a JSON array")
        self.layers_parse(description)
        self.layers_init()
        if "mapping" not in profile:
            raise ErasureCodeValidationError(
                "the 'mapping' profile is missing")
        mapping = profile["mapping"]
        self.data_chunk_count_ = mapping.count("D")
        self.chunk_count_ = len(mapping)
        self.layers_sanity_checks()
        super().init(profile)
        if kml_used:
            # generated parameters are not exposed (reference :535-543)
            for key in ("mapping", "layers", "crush-steps"):
                self._profile.pop(key, None)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)  # mapping= -> chunk_mapping
        self.rule_root = self.to_string("crush-root", profile, "default")
        self.rule_device_class = self.to_string("crush-device-class",
                                                profile, "")
        if "crush-steps" in profile:
            steps = _json_loads_lenient(profile["crush-steps"])
            self.rule_steps = []
            for step in steps:
                if (not isinstance(step, list) or len(step) != 3 or
                        not isinstance(step[0], str) or
                        not isinstance(step[1], str)):
                    raise ErasureCodeValidationError(
                        f"crush-steps entry {step!r} must be "
                        "[op, type, n]")
                self.rule_steps.append((step[0], step[1], int(step[2])))

    def parse_kml(self, profile: ErasureCodeProfile) -> bool:
        """Generate mapping/layers/crush-steps from k, m, l
        (reference :293-397).  Returns True when the kml form was used."""
        k = self.to_int("k", profile, DEFAULT_KML)
        m = self.to_int("m", profile, DEFAULT_KML)
        l = self.to_int("l", profile, DEFAULT_KML)
        if (k, m, l) == (-1, -1, -1):
            for key in ("k", "m", "l"):
                profile.pop(key, None)
            return False
        if -1 in (k, m, l):
            raise ErasureCodeValidationError(
                "All of k, m, l must be set or none of them")
        for key in ("mapping", "layers", "crush-steps"):
            if key in profile:
                raise ErasureCodeValidationError(
                    f"The {key} parameter cannot be set when k, m, l are set")
        if l == 0 or (k + m) % l:
            raise ErasureCodeValidationError(
                "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ErasureCodeValidationError(
                "k must be a multiple of (k + m) / l")
        if m % groups:
            raise ErasureCodeValidationError(
                "m must be a multiple of (k + m) / l")

        mapping = ""
        for _ in range(groups):
            mapping += "D" * (k // groups) + "_" * (m // groups) + "_"
        profile["mapping"] = mapping

        layers = []
        global_map = ""
        for _ in range(groups):
            global_map += "D" * (k // groups) + "c" * (m // groups) + "_"
        layers.append([global_map, ""])
        for i in range(groups):
            local_map = ""
            for j in range(groups):
                local_map += ("D" * l + "c") if i == j else "_" * (l + 1)
            layers.append([local_map, ""])
        profile["layers"] = json.dumps(layers)

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [("choose", locality, groups),
                               ("chooseleaf", failure_domain, l + 1)]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]
        return True

    def layers_parse(self, description: list) -> None:
        for position, layer_json in enumerate(description):
            if not isinstance(layer_json, list) or not layer_json:
                raise ErasureCodeValidationError(
                    f"each element of layers must be a JSON array "
                    f"(position {position})")
            if not isinstance(layer_json[0], str):
                raise ErasureCodeValidationError(
                    f"layer {position} chunks map must be a string")
            layer = Layer(layer_json[0])
            if len(layer_json) > 1:
                layer.profile = _parse_layer_profile(layer_json[1])
            self.layers.append(layer)

    def layers_init(self) -> None:
        registry = ecreg.instance()
        for layer in self.layers:
            for position, ch in enumerate(layer.chunks_map):
                if ch == "D":
                    layer.data.append(position)
                if ch == "c":
                    layer.coding.append(position)
                if ch in ("c", "D"):
                    layer.chunks_as_set.add(position)
            layer.chunks = layer.data + layer.coding
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin",
                                     getattr(self, "inner_plugin",
                                             "jerasure"))
            layer.profile.setdefault("technique", "reed_sol_van")
            if layer.profile["plugin"] == "gpu" and \
                    getattr(self, "inner_device", None) is not None:
                layer.profile.setdefault("device", self.inner_device)
            layer.erasure_code = registry.factory(layer.profile["plugin"],
                                                  layer.profile)

    def layers_sanity_checks(self) -> None:
        if len(self.layers) < 1:
            raise ErasureCodeValidationError(
                "layers parameter needs at least one layer")
        for layer in self.layers:
            if len(layer.chunks_map) != self.chunk_count_:
                raise ErasureCodeValidationError(
                    f"layer map '{layer.chunks_map}' is expected to be "
                    f"{self.chunk_count_} characters long but is "
                    f"{len(layer.chunks_map)}")

    # -- minimum_to_decode (reference :566-735) ---------------------------
    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        erasures_total = {i for i in range(self.get_chunk_count())
                          if i not in available_chunks}
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & want_to_read

        # Case 1: nothing wanted is missing
        if not erasures_want:
            return set(want_to_read)

        # Case 2: recover wanted erasures with as few chunks as possible,
        # walking layers from most local (last) to global (first)
        minimum: Set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_as_set & erasures_not_recovered
                if len(erasures) > \
                        layer.erasure_code.get_coding_chunk_count():
                    continue  # too many for this layer; try upper layers
                layer_minimum = layer.chunks_as_set - erasures_not_recovered
                erasures_not_recovered -= erasures
                erasures_want -= erasures
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= want_to_read
            minimum -= erasures_total
            return minimum

        # Case 3: recover everything recoverable, hoping it unblocks the
        # upper layers; if all erasures are then covered, read everything
        erasures_total = {i for i in range(self.get_chunk_count())
                          if i not in available_chunks}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= \
                    layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available_chunks)
        raise IOError(
            f"not enough chunks in {sorted(available_chunks)} to read "
            f"{sorted(want_to_read)}")

    # -- encode (reference :737-776) --------------------------------------
    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, np.ndarray]) -> None:
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want_to_encode <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_want: Set[int] = set()
            layer_encoded: Dict[int, np.ndarray] = {}
            for j, c in enumerate(layer.chunks):
                layer_encoded[j] = encoded[c]
                if c in want_to_encode:
                    layer_want.add(j)
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """Batched layered encode: uint8 [B, k, L] -> parity
        [B, n-k, L] (code-position order k..n-1).  ONE inner encode
        per LAYER over the whole object batch — where the per-object
        path pays len(layers) inner calls per object, this pays
        len(layers) total (LRC's layers are independent row-sets over
        the same chunks; batch them).
        Chunk buffers flow through the same encode_chunks layer walk
        (reference ErasureCodeLrc.cc:737-776), which is
        batch-transparent."""
        data = np.asarray(data, dtype=np.uint8)
        B, k, L = data.shape
        if k != self.get_data_chunk_count():
            raise ValueError(
                f"expected [batch, k={self.get_data_chunk_count()}, "
                f"L] input")
        n = self.get_chunk_count()
        encoded: Dict[int, np.ndarray] = {}
        for i in range(k):
            encoded[self.chunk_index(i)] = np.ascontiguousarray(
                data[:, i])
        for i in range(k, n):
            encoded[self.chunk_index(i)] = np.zeros((B, L),
                                                    dtype=np.uint8)
        self.encode_chunks(set(range(n)), encoded)
        return np.stack([encoded[self.chunk_index(i)]
                         for i in range(k, n)], axis=1)

    def encode_batch_device(self, dev_data):
        """Device-resident batched layered encode: torch tensor
        [B, k, L] in -> parity tensor [B, n-k, L] on the same device,
        no host round trip between layers (the codec-kernel boundary,
        matching the headline's framing).  Each layer's chunks are
        gathered with torch.stack on the tensor's device (a contiguous
        [B, lk, L], as kernel B1 takes it) and encoded through the
        inner plugin's encode_batch_device, so parity produced by
        earlier layers feeds later layers without leaving the card.
        Requires every inner plugin to expose encode_batch_device (the
        gpu plugin)."""
        B, k, L = dev_data.shape
        n = self.get_chunk_count()
        chunks: Dict[int, torch.Tensor] = {}
        for i in range(k):
            chunks[self.chunk_index(i)] = dev_data[:, i]
        for layer in self.layers:
            inner = layer.erasure_code
            lk = inner.get_data_chunk_count()
            stack = torch.stack([chunks[c] for c in layer.chunks[:lk]],
                                dim=1)
            parity = inner.encode_batch_device(stack)
            for idx, c in enumerate(layer.chunks[lk:]):
                chunks[c] = parity[:, idx]
        return torch.stack([chunks[self.chunk_index(i)]
                            for i in range(k, n)], dim=1)

    # -- decode (reference :777-860) --------------------------------------
    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: Dict[int, np.ndarray]) -> None:
        erasures = {i for i in range(self.get_chunk_count())
                    if i not in chunks}
        want_to_read_erasures = erasures & want_to_read
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > \
                    layer.erasure_code.get_coding_chunk_count():
                continue  # too many erasures for this layer
            if not layer_erasures:
                continue  # all available already
            layer_want: Set[int] = set()
            layer_chunks: Dict[int, np.ndarray] = {}
            layer_decoded: Dict[int, np.ndarray] = {}
            for j, c in enumerate(layer.chunks):
                # pick from `decoded` to reuse chunks recovered by more
                # local layers
                if c not in erasures:
                    layer_chunks[j] = decoded[c]
                if c in want_to_read:
                    layer_want.add(j)
                layer_decoded[j] = decoded[c]
            layer.erasure_code.decode_chunks(layer_want, layer_chunks,
                                             layer_decoded)
            for j, c in enumerate(layer.chunks):
                decoded[c][:] = layer_decoded[j]
                erasures.discard(c)
            want_to_read_erasures = erasures & want_to_read
            if not want_to_read_erasures:
                break
        if want_to_read_erasures:
            raise IOError(
                f"unable to read {sorted(want_to_read_erasures)}")

    # -- CRUSH (reference :60-141 create_rule with steps) -----------------
    def create_rule(self, name: str, crush) -> int:
        ruleid = crush.add_steps_rule(name, self.rule_root,
                                      self.rule_device_class,
                                      self.rule_steps,
                                      pool_type="erasure")
        crush.set_rule_mask_max_size(ruleid, self.get_chunk_count())
        return ruleid


class ErasureCodePluginLrc(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile):
        codec = ErasureCodeLrc()
        codec.init(profile)
        return codec


def __erasure_code_init__(registry) -> None:
    registry.add("lrc", ErasureCodePluginLrc())
