"""CRUSH placement mapper.

Python-native re-implementation of the CRUSH algorithm (Weil et al.,
"CRUSH: Controlled, Scalable, Decentralized Placement of Replicated
Data", SC'06) with the behavior of the reference's pure-C mapper
(reference src/crush/mapper.c:900 ``crush_do_rule``): straw2 bucket
selection via per-item exponential draws, ``firstn`` placement for
replicated pools (collisions retried, survivors shift left) and
``indep`` placement for EC pools (positionally stable; a failed
position leaves a ``CRUSH_ITEM_NONE`` hole instead of reshuffling —
reference crush_choose_indep mapper.c:666, and the "Crush" section of
doc/dev/osd_internals/erasure_coding/ecbackend.rst).

The hash is Jenkins' public-domain 32-bit mix (burtleburtle.net — the
same one the reference uses, crush/hash.c), so placements are
deterministic for any (map, rule, x) on any host.  Straw2 draws use
float64 log instead of the reference's fixed-point ln table — equally
deterministic (IEEE 754), not bit-identical to the reference (doesn't
need to be: placement only has to agree *within* a cluster).

Weights are 16.16 fixed point (0x10000 == weight 1.0) as in the
reference, so ``is_out`` reweight probabilities behave identically.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

CRUSH_ITEM_UNDEF = -0x7FFFFFFF  # mapper.c CRUSH_ITEM_UNDEF
CRUSH_ITEM_NONE = 0x7FFFFFFF    # hole in an indep result

_M32 = 0xFFFFFFFF


def _mix(a: int, b: int, c: int):
    """Jenkins 96-bit mix (public domain; crush/hash.c crush_hashmix)."""
    a = (a - b - c) & _M32; a ^= c >> 13
    b = (b - c - a) & _M32; b ^= (a << 8) & _M32
    c = (c - a - b) & _M32; c ^= b >> 13
    a = (a - b - c) & _M32; a ^= c >> 12
    b = (b - c - a) & _M32; b ^= (a << 16) & _M32
    c = (c - a - b) & _M32; c ^= b >> 5
    a = (a - b - c) & _M32; a ^= c >> 3
    b = (b - c - a) & _M32; b ^= (a << 10) & _M32
    c = (c - a - b) & _M32; c ^= b >> 15
    return a, b, c


_SEED = 1315423911


def crush_hash32_2(a: int, b: int) -> int:
    a &= _M32; b &= _M32
    h = (_SEED ^ a ^ b) & _M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= _M32; b &= _M32; c &= _M32
    h = (_SEED ^ a ^ b ^ c) & _M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


class Bucket:
    """An interior node of the hierarchy (reference crush_bucket).

    alg 'straw2' (default) or 'uniform'.  ``id`` is negative; items are
    device ids (>= 0) or child bucket ids (< 0); weights 16.16 fixed
    point.  A uniform bucket uses one weight for all items.
    """

    def __init__(self, id: int, type: int, alg: str = "straw2",
                 items: Optional[List[int]] = None,
                 weights: Optional[List[int]] = None):
        assert id < 0, "bucket ids are negative"
        self.id = id
        self.type = type
        self.alg = alg
        self.items: List[int] = list(items or [])
        self.weights: List[int] = list(weights or [])

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    def add_item(self, item: int, weight: int) -> None:
        self.items.append(item)
        self.weights.append(weight)

    def remove_item(self, item: int) -> None:
        i = self.items.index(item)
        del self.items[i]
        del self.weights[i]

    def adjust_item_weight(self, item: int, weight: int) -> None:
        self.weights[self.items.index(item)] = weight

    # -- selection --------------------------------------------------------
    def choose(self, x: int, r: int) -> int:
        if self.alg == "uniform":
            # reference bucket_uniform_choose/bucket_perm_choose
            # approximated by an r-keyed hash pick — positional, stable
            i = crush_hash32_3(x, self.id & _M32, r) % self.size
            return self.items[i]
        return self._straw2_choose(x, r)

    def _straw2_choose(self, x: int, r: int) -> int:
        """Max of per-item exponential draws ln(u)/w (reference
        bucket_straw2_choose, mapper.c:361)."""
        high = 0
        high_draw = -math.inf
        for i, item in enumerate(self.items):
            w = self.weights[i]
            if w:
                u = crush_hash32_3(x, item & _M32, r) & 0xFFFF
                # u==0 maps to the most negative draw, as the reference's
                # ln table does at its lower bound
                draw = math.log((u + 1) / 0x10000) / (w / 0x10000)
            else:
                draw = -math.inf
            if i == 0 or draw > high_draw:
                high = i
                high_draw = draw
        return self.items[high]


class Rule:
    """A placement rule: list of steps (reference crush_rule).

    Steps: ("take", bucket_id) | ("choose_firstn", n, type)
    | ("chooseleaf_firstn", n, type) | ("choose_indep", n, type)
    | ("chooseleaf_indep", n, type) | ("emit",)
    | ("set_choose_tries", n) | ("set_chooseleaf_tries", n)
    n <= 0 means result_max + n.
    """

    def __init__(self, name: str, steps: List[tuple],
                 rule_type: str = "replicated", max_size: int = 10):
        self.name = name
        self.steps = steps
        self.rule_type = rule_type
        self.max_size = max_size


class CrushMap:
    """The map: devices + buckets + rules + tunables
    (reference struct crush_map)."""

    def __init__(self) -> None:
        self.buckets: Dict[int, Bucket] = {}
        self.rules: List[Rule] = []
        self.max_devices = 0
        # reference modern tunable profile (jewel+)
        self.choose_total_tries = 50
        self.chooseleaf_descend_once = True
        self.chooseleaf_vary_r = 1
        self.chooseleaf_stable = 1

    def add_bucket(self, bucket: Bucket) -> None:
        self.buckets[bucket.id] = bucket

    def new_bucket_id(self) -> int:
        return min(self.buckets, default=0) - 1

    def note_device(self, dev: int) -> None:
        self.max_devices = max(self.max_devices, dev + 1)

    # -- the mapper -------------------------------------------------------
    def is_out(self, weight: Sequence[int], item: int, x: int) -> bool:
        """Reweight check (reference mapper.c:429-443): weight 0x10000
        is always in, 0 always out, else probabilistic on hash."""
        if item >= len(weight):
            return True
        w = weight[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (crush_hash32_2(x, item) & 0xFFFF) >= w

    def _choose_firstn(self, bucket: Bucket, weight: Sequence[int], x: int,
                       numrep: int, type: int, out: List[int],
                       tries: int, recurse_tries: int,
                       recurse_to_leaf: bool, stable: int, vary_r: int,
                       out2: Optional[List[int]], parent_r: int) -> None:
        """Depth-first choose with retry-on-collision (reference
        crush_choose_firstn, mapper.c:476)."""
        start = 0 if stable else len(out)
        for rep in range(start, numrep):
            ftotal = 0
            skip_rep = False
            while True:  # retry_descent
                retry_descent = False
                node = bucket
                while True:  # retry_bucket
                    retry_bucket = False
                    collide = False
                    reject = False
                    r = rep + parent_r + ftotal
                    if node.size == 0:
                        reject = True
                    else:
                        item = node.choose(x, r)
                        if item < 0 and item not in self.buckets:
                            skip_rep = True  # dangling child id
                            break
                        itemtype = (self.buckets[item].type
                                    if item < 0 else 0)
                        if itemtype != type:
                            if item >= 0:
                                skip_rep = True
                                break
                            node = self.buckets[item]
                            retry_bucket = True
                            continue
                        collide = item in out
                        if not collide and recurse_to_leaf and item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            sub_out: List[int] = list(out2 or [])
                            want = 1 if stable else len(out) + 1
                            self._choose_firstn(
                                self.buckets[item], weight, x, want, 0,
                                sub_out, recurse_tries, 0, False,
                                stable, vary_r, None, sub_r)
                            if len(sub_out) <= len(out):
                                reject = True
                            elif out2 is not None:
                                out2.append(sub_out[-1])
                        elif not collide and recurse_to_leaf \
                                and out2 is not None:
                            out2.append(item)
                        if not reject and not collide and itemtype == 0:
                            reject = self.is_out(weight, item, x)
                    if reject or collide:
                        if recurse_to_leaf and not collide and \
                                out2 and len(out2) > len(out):
                            out2.pop()  # undo leaf for rejected subtree
                        ftotal += 1
                        if ftotal < tries:
                            retry_descent = True
                        else:
                            skip_rep = True
                        break
                    break
                if not retry_descent:
                    break
            if skip_rep:
                continue
            out.append(item)

    def _choose_indep(self, bucket: Bucket, weight: Sequence[int], x: int,
                      left: int, numrep: int, type: int,
                      out: List[int], outpos: int,
                      tries: int, recurse_tries: int,
                      recurse_to_leaf: bool,
                      out2: Optional[List[int]], parent_r: int) -> None:
        """Breadth-first positionally-stable choose (reference
        crush_choose_indep, mapper.c:666): each position keeps its item
        across other positions' failures; irrecoverable positions
        become CRUSH_ITEM_NONE holes."""
        endpos = outpos + left
        for rep in range(outpos, endpos):
            out[rep] = CRUSH_ITEM_UNDEF
            if out2 is not None:
                out2[rep] = CRUSH_ITEM_UNDEF
        ftotal = 0
        while left > 0 and ftotal < tries:
            for rep in range(outpos, endpos):
                if out[rep] != CRUSH_ITEM_UNDEF:
                    continue
                node = bucket
                while True:
                    r = rep + parent_r
                    if node.alg == "uniform" and node.size % numrep == 0:
                        r += (numrep + 1) * ftotal
                    else:
                        r += numrep * ftotal
                    if node.size == 0:
                        break
                    item = node.choose(x, r)
                    if item < 0 and item not in self.buckets:
                        out[rep] = CRUSH_ITEM_NONE  # dangling child id
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    itemtype = self.buckets[item].type if item < 0 else 0
                    if itemtype != type:
                        if item >= 0:
                            out[rep] = CRUSH_ITEM_NONE
                            if out2 is not None:
                                out2[rep] = CRUSH_ITEM_NONE
                            left -= 1
                            break
                        node = self.buckets[item]
                        continue
                    if item in out[outpos:endpos]:  # collision
                        break
                    if recurse_to_leaf and item < 0:
                        assert out2 is not None
                        self._choose_indep(
                            self.buckets[item], weight, x, 1, numrep, 0,
                            out2, rep, recurse_tries, 0, False, None, r)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    elif recurse_to_leaf and out2 is not None:
                        out2[rep] = item
                    if itemtype == 0 and self.is_out(weight, item, x):
                        break
                    out[rep] = item
                    left -= 1
                    break
            ftotal += 1
        for rep in range(outpos, endpos):
            if out[rep] == CRUSH_ITEM_UNDEF:
                out[rep] = CRUSH_ITEM_NONE
            if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
                out2[rep] = CRUSH_ITEM_NONE

    def do_rule(self, ruleno: int, x: int, result_max: int,
                weight: Sequence[int]) -> List[int]:
        """Run a rule (reference crush_do_rule, mapper.c:900).

        ``weight`` is the per-device 16.16 in/out vector (the OSDMap's
        osd_weight, NOT the crush hierarchy weights).
        """
        if not 0 <= ruleno < len(self.rules):
            return []
        rule = self.rules[ruleno]
        result: List[int] = []
        w: List[int] = []
        choose_tries = self.choose_total_tries + 1
        choose_leaf_tries = 0
        vary_r = self.chooseleaf_vary_r
        stable = self.chooseleaf_stable

        for step in rule.steps:
            op = step[0]
            if op == "take":
                target = step[1]
                if target in self.buckets or 0 <= target < self.max_devices:
                    w = [target]
            elif op == "set_choose_tries":
                if step[1] > 0:
                    choose_tries = step[1]
            elif op == "set_chooseleaf_tries":
                if step[1] > 0:
                    choose_leaf_tries = step[1]
            elif op == "emit":
                for item in w:
                    if len(result) < result_max:
                        result.append(item)
                w = []
            elif op in ("choose_firstn", "chooseleaf_firstn",
                        "choose_indep", "chooseleaf_indep"):
                numrep, type = step[1], step[2]
                firstn = op.endswith("_firstn")
                recurse_to_leaf = op.startswith("chooseleaf")
                o: List[int] = []
                c: List[int] = []
                for wi in w:
                    n = numrep
                    if n <= 0:
                        n += result_max
                        if n <= 0:
                            continue
                    if wi not in self.buckets:
                        continue
                    bucket = self.buckets[wi]
                    if firstn:
                        recurse_tries = (
                            choose_leaf_tries or
                            (1 if self.chooseleaf_descend_once
                             else choose_tries))
                        self._choose_firstn(
                            bucket, weight, x, n, type, o,
                            choose_tries, recurse_tries,
                            recurse_to_leaf, stable, vary_r, c, 0)
                    else:
                        out_size = min(n, result_max - len(o))
                        base = len(o)
                        o.extend([CRUSH_ITEM_UNDEF] * out_size)
                        c.extend([CRUSH_ITEM_UNDEF] * out_size)
                        self._choose_indep(
                            bucket, weight, x, out_size, n, type,
                            o, base, choose_tries,
                            choose_leaf_tries or 1,
                            recurse_to_leaf, c if recurse_to_leaf else None,
                            0)
                w = list(c if recurse_to_leaf else o)
            else:
                raise ValueError(f"unknown rule step {op!r}")
        return result
