"""Monitor quorum: leader election + Paxos map replication.

Python-native equivalent of the reference's quorum machinery
(reference ``src/mon/Elector.{h,cc}`` + ``mon/ElectionLogic.cc`` for
election, ``src/mon/Paxos.{h,cc}`` 1.6k LoC for replicated commits),
reduced to the collapsed single-decree-at-a-time form the reference
actually runs (Paxos.cc "we only do one round at a time"):

* **Election** (classic strategy): a candidate proposes with its
  ``last_committed``; peers defer to the candidate with the newest
  data, ties broken by lowest rank (reference ElectionLogic::
  receive_propose), and within one epoch only to a candidate better
  than the one they already acked (``leader_acked``).  Acks from every
  monitor -> victory at once; a majority only -> victory when the
  election period ends, if the candidate has not deferred meanwhile
  (reference ElectionLogic::receive_ack / end_election_period); epoch
  is odd during elections, bumped even on victory (reference
  Elector::bump_epoch).
* **Paxos commit**: the leader turns each map mutation into a proposed
  full-map value, sends ``begin`` to the quorum, waits for a majority
  of ``accept``s, then commits locally and broadcasts ``commit``
  (reference Paxos::begin/handle_accept/commit).  Peons persist and
  publish on commit.
* **Leases**: the leader refreshes peons with ``lease`` every tick;
  a peon whose lease expires calls a new election (reference
  Paxos::lease_timeout -> mon->call_election).
* **Catch-up**: election acks carry last_committed; after victory the
  leader ships stragglers the missing map epochs (``sync``) before
  new proposals (reference Paxos collect/last phase + mon sync).

Commands that mutate the map only run on the leader; peons answer
``MMonCommand`` with a redirect carrying the leader's address
(the reference forwards instead — MRoute — but the observable
behavior, "any mon can be asked, the leader answers", is the same).
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..msg.messages import MMonMon
from ..utils.log import Dout


class Proposal:
    def __init__(self, version: int, value: dict, needed: int,
                 epoch: int):
        self.version = version
        self.value = value
        self.needed = needed             # majority count
        self.epoch = epoch               # election epoch of this round
        self.accepted: Set[int] = set()
        self.done = threading.Event()
        self.ok = False


class QuorumService:
    """Election + paxos state for one monitor (reference Elector +
    Paxos members on Monitor)."""

    def __init__(self, mon, rank: int,
                 monmap: List[Tuple[str, int]]) -> None:
        self.mon = mon
        self.rank = rank
        self.monmap = list(monmap)       # rank -> addr
        self.log = Dout("mon", f"{mon.name} quorum ")
        self.election_epoch = 0
        self.leader: Optional[int] = None if len(monmap) > 1 else rank
        self.quorum: Set[int] = {rank}
        self._acks: Dict[int, int] = {}  # rank -> last_committed
        # the candidate this monitor acked in the current election, and
        # its (last_committed, -rank): only a better one is acked next
        # (reference ElectionLogic leader_acked)
        self._deferred_to: Optional[int] = None
        self._deferred_key: Optional[Tuple[int, int]] = None
        self._election_started = 0.0
        self._lease_expiry = 0.0
        self._proposal: Optional[Proposal] = None
        # peon: pending begin awaiting commit, as (version, value, pn)
        # where pn is the election epoch of the begin that carried it
        # (reference Paxos accepted_pn)
        self._pending: Optional[Tuple[int, dict, int]] = None
        # candidate: accepted-but-uncommitted values carried in acks,
        # version -> (pn, value); only the highest-pn value per version
        # may be completed (reference Paxos uncommitted_pn handling)
        self._ack_pendings: Dict[int, Tuple[int, dict]] = {}
        # set lock-free by handle() when evidence of a newer election
        # arrives: lets propose() (which blocks holding mon.lock, so
        # handlers couldn't depose us through the lock) bail out early
        self._deposed_hint = threading.Event()

    # ----------------------------------------------------------------- #
    @property
    def n_mons(self) -> int:
        return len(self.monmap)

    @property
    def majority(self) -> int:
        return self.n_mons // 2 + 1

    def is_leader(self) -> bool:
        return self.leader == self.rank

    def in_quorum(self) -> bool:
        return self.leader is not None

    def leader_addr(self) -> Optional[Tuple[str, int]]:
        if self.leader is None:
            return None
        return self.monmap[self.leader]

    def _send(self, rank: int, msg: MMonMon) -> None:
        if rank == self.rank:
            return
        try:
            conn = self.mon.msgr.connect_to(
                (self.monmap[rank][0], int(self.monmap[rank][1])),
                peer_name=f"mon.{rank}")
            conn.send_message(msg)
        except Exception:
            pass

    def _broadcast(self, msg: MMonMon,
                   ranks: Optional[Set[int]] = None) -> None:
        """Send ``msg`` to every other monitor (or to ``ranks``), each
        its own copy: a connection stamps its sequence number on the
        message object it sends, so one object queued on two
        connections carries the first one's number on both, and the
        second peer then drops as duplicates the messages of its own
        session numbered below it (a lagging monitor never got the
        maps it asked for)."""
        for r in range(self.n_mons):
            if r != self.rank and (ranks is None or r in ranks):
                one = copy.copy(msg)
                one.seq, one.hops = 0, None
                self._send(r, one)

    # ----------------------------------------------------------------- #
    # election (reference ElectionLogic classic strategy)
    # ----------------------------------------------------------------- #
    def start_election(self, floor: int = 0) -> None:
        """``floor``: ratchet at least past this epoch first (joining
        a newer round someone else already opened)."""
        with self.mon.lock:
            if self.n_mons == 1:
                self.leader = self.rank
                self.quorum = {self.rank}
                return
            self.election_epoch = max(self.election_epoch, floor)
            if self.election_epoch % 2 == 0:
                self.election_epoch += 1      # odd = electing
            else:
                self.election_epoch += 2
            self.leader = None
            self._deferred_to = None
            self._deferred_key = None
            self._acks = {self.rank: self.mon.osdmap.epoch}
            self._ack_pendings = {}
            self._election_started = time.monotonic()
            epoch = self.election_epoch
            lc = self.mon.osdmap.epoch
        self.log.dout(5, f"starting election e{epoch}")
        self._broadcast(MMonMon(op="propose", from_rank=self.rank,
                                epoch=epoch, last_committed=lc))

    def _defers_to(self, their_lc: int, their_rank: int) -> bool:
        """True if (their_lc, -their_rank) beats ours: newest data
        wins, lowest rank breaks ties (reference receive_propose)."""
        mine = (self.mon.osdmap.epoch, -self.rank)
        theirs = (their_lc, -their_rank)
        return theirs > mine

    def _handle_propose(self, msg: MMonMon) -> None:
        reply = None
        with self.mon.lock:
            if msg.epoch < self.election_epoch and \
                    self.election_epoch % 2 == 1:
                return                   # stale round
            stable = self.election_epoch % 2 == 0 and \
                self.leader is not None
            theirs = (msg.last_committed, -msg.from_rank)
            if self._deferred_key is not None and \
                    msg.epoch == self.election_epoch and \
                    theirs < self._deferred_key:
                # already acked a better candidate in this round: a
                # second ack would hand both a majority (reference
                # propose_classic_handler "no, we already acked")
                return
            if self._defers_to(msg.last_committed, msg.from_rank):
                self.election_epoch = max(self.election_epoch, msg.epoch)
                if self.election_epoch % 2 == 0:
                    self.election_epoch += 1
                self.leader = None
                self._deferred_to = msg.from_rank
                self._deferred_key = theirs
                self._election_started = time.monotonic()
                epoch = self.election_epoch
                lc = self.mon.osdmap.epoch
                rank = msg.from_rank
            elif stable and self.is_leader() and \
                    msg.epoch <= self.election_epoch:
                # a worse candidate probing an old round while we hold
                # a stable quorum: re-assert instead of dissolving it
                # (reference Elector nak/assert-victory behavior)
                reply = MMonMon(op="victory", from_rank=self.rank,
                                  epoch=self.election_epoch,
                                  quorum=sorted(self.quorum),
                                  last_committed=self.mon.osdmap.epoch)
                rank = msg.from_rank
            elif stable and self.is_leader():
                # they're in a NEWER round: a stale-epoch victory would
                # be dropped and livelock them — contest and win the
                # new round with our data
                rank = None
            elif stable:
                # peon with a live leader: the leader's lease will
                # teach the proposer; abandoning our quorum here would
                # wedge in-flight paxos rounds
                return
            elif self.election_epoch % 2 == 1:
                # already electing and they're worse: re-send OUR
                # candidacy.  Ratchet up to their round first
                # (reference Elector::bump_epoch ratchets on every
                # message) — countering at a stale epoch would be
                # dropped by their stale-round check and livelock the
                # election.  Don't bump past it: leapfrogging a
                # concurrent victory splits the quorum.
                if msg.epoch > self.election_epoch:
                    self.election_epoch = msg.epoch \
                        if msg.epoch % 2 == 1 else msg.epoch + 1
                    self._acks = {self.rank: self.mon.osdmap.epoch}
                    self._deferred_to = self._deferred_key = None
                    self._election_started = time.monotonic()
                counter = MMonMon(op="propose", from_rank=self.rank,
                                  epoch=self.election_epoch,
                                  last_committed=self.mon.osdmap.epoch)
                rank = msg.from_rank
                reply = counter
            else:
                rank = None
        if reply is not None:
            self._send(rank, reply)
        elif rank is not None:
            # the ack carries any accepted-but-uncommitted value
            # (reference Paxos collect/last phase): a leader that died
            # between majority-accept and commit-broadcast had already
            # acked the client — the new leader must complete the
            # round, not lose it
            with self.mon.lock:
                pend = self._pending
            self._send(rank, MMonMon(
                op="ack", from_rank=self.rank, epoch=epoch,
                last_committed=lc,
                version=pend[0] if pend else 0,
                value=pend[1] if pend else None,
                pn=pend[2] if pend else 0))
        else:
            # they're worse but opened a round: contest it, ratcheting
            # at least past their epoch
            self.start_election(msg.epoch)

    def _handle_ack(self, msg: MMonMon) -> None:
        with self.mon.lock:
            if msg.epoch != self.election_epoch or self.in_quorum() \
                    or self._deferred_to is not None:
                return                   # stale, or no longer a candidate
            self._acks[msg.from_rank] = msg.last_committed
            if msg.version and msg.value is not None:
                prev = self._ack_pendings.get(msg.version)
                if prev is None or msg.pn > prev[0]:
                    self._ack_pendings[msg.version] = (msg.pn,
                                                      msg.value)
            # every monitor acked: no better candidate can be left, so
            # win now; a bare majority waits for the election period to
            # end (tick), in which a better candidate's propose arrives
            # and makes this one defer
            everyone = len(self._acks) == self.n_mons
        if everyone:
            self._declare_victory()

    def _declare_victory(self) -> None:
        with self.mon.lock:
            if self.in_quorum() or self._deferred_to is not None or \
                    self.election_epoch % 2 == 0 or \
                    len(self._acks) < self.majority:
                return
            # victory: epoch goes even, quorum = the acked set
            self.election_epoch += 1
            self.leader = self.rank
            self.quorum = set(self._acks)
            epoch = self.election_epoch
            quorum = sorted(self.quorum)
            acks = dict(self._acks)
            # complete uncommitted rounds (reference Paxos collect):
            # our own pending plus any carried in acks.  Values for the
            # same version compete by pn — a value the dead leader got
            # majority-accepted (and possibly committed on some mons)
            # carries the newest begin's epoch, so highest pn wins;
            # completing a lower-pn loser could fork the committed map
            # between monitor incarnations.
            pendings = dict(self._ack_pendings)
            if self._pending is not None:
                v, val, pn = self._pending
                prev = pendings.get(v)
                if prev is None or pn > prev[0]:
                    pendings[v] = (pn, val)
            self._ack_pendings = {}
        for version in sorted(pendings):
            if version > self.mon.osdmap.epoch:
                self.mon.apply_replicated(version,
                                          pendings[version][1])
        with self.mon.lock:
            my_lc = self.mon.osdmap.epoch
        self.log.dout(1, f"won election e{epoch}, quorum {quorum}")
        self._broadcast(MMonMon(op="victory", from_rank=self.rank,
                                epoch=epoch, quorum=quorum,
                                last_committed=my_lc))
        # catch stragglers up (reference paxos collect/last phase)
        for r, lc in acks.items():
            if r != self.rank and lc < my_lc:
                self._send_sync(r, lc)
        self.mon.on_quorum_formed()

    def _handle_victory(self, msg: MMonMon) -> None:
        with self.mon.lock:
            if msg.epoch < self.election_epoch:
                return
            if msg.last_committed < self.mon.osdmap.epoch:
                # the "winner" has older data than us (it won without
                # hearing from us): adopting it would fork the map —
                # contest with our newer lc instead
                contest = True
            else:
                contest = False
                self.election_epoch = msg.epoch
                self.leader = msg.from_rank
                self.quorum = set(msg.quorum)
                self._lease_expiry = time.monotonic() + \
                    self.mon.conf["mon_lease"] - \
                    self.mon.conf["mon_clock_drift_allowed"]
        if contest:
            self.start_election()
            return
        self.log.dout(5, f"mon.{msg.from_rank} is leader "
                      f"(e{msg.epoch})")
        if msg.last_committed > self.mon.osdmap.epoch:
            self._send(msg.from_rank, MMonMon(
                op="sync_req", from_rank=self.rank,
                last_committed=self.mon.osdmap.epoch))

    # ----------------------------------------------------------------- #
    # paxos (reference Paxos::begin / handle_accept / commit)
    # ----------------------------------------------------------------- #
    def propose(self, version: int, value: dict,
                timeout: float = 5.0) -> bool:
        """Leader: replicate one committed map (blocking until a
        majority accepted; caller holds no locks).  Single-mon quorums
        short-circuit."""
        if not self.is_leader():
            raise RuntimeError("propose on non-leader")
        if self.n_mons == 1 or len(self.quorum) == 1:
            return True
        prop = Proposal(version, value, self.majority,
                        self.election_epoch)
        prop.accepted.add(self.rank)
        self._proposal = prop
        self._broadcast(MMonMon(op="begin", from_rank=self.rank,
                                epoch=self.election_epoch,
                                version=version, value=value),
                        ranks=self.quorum)
        deadline = time.monotonic() + timeout
        self._deposed_hint.clear()
        while not prop.done.wait(0.25):
            if not self.is_leader() or self._deposed_hint.is_set():
                # deposed mid-round (newer election elsewhere): stop
                # blocking the mon lock; catch-up reconciles the maps
                self._proposal = None
                return False
            if time.monotonic() > deadline:
                self._proposal = None
                # lost the quorum mid-proposal: force a new election
                self.start_election()
                return False
        self._proposal = None
        self._broadcast(MMonMon(op="commit", from_rank=self.rank,
                                epoch=self.election_epoch,
                                version=version),
                        ranks=self.quorum)
        return True

    def _handle_begin(self, msg: MMonMon) -> None:
        if self.leader != msg.from_rank:
            # trust a begin from a same-or-newer epoch: we may simply
            # not have processed the victory yet (in-order conns make
            # this rare; cheap to tolerate)
            if msg.epoch >= self.election_epoch:
                with self.mon.lock:
                    self.leader = msg.from_rank
                    self.election_epoch = msg.epoch
            else:
                return
        with self.mon.lock:
            behind = self.mon.osdmap.epoch \
                if msg.version > self.mon.osdmap.epoch + 1 else None
            self._pending = (msg.version, msg.value, msg.epoch)
        if behind is not None:
            # gap before this value: ask for the missing epochs too
            self._send(msg.from_rank, MMonMon(
                op="sync_req", from_rank=self.rank,
                last_committed=behind))
        self._send(msg.from_rank, MMonMon(
            op="accept", from_rank=self.rank, epoch=msg.epoch,
            version=msg.version))

    def _handle_accept(self, msg: MMonMon) -> None:
        prop = self._proposal
        if prop is None or msg.version != prop.version \
                or msg.epoch != prop.epoch:
            # a stale accept from an aborted round must not vouch for
            # a different value re-proposed under the same version
            return
        prop.accepted.add(msg.from_rank)
        if len(prop.accepted) >= prop.needed:
            prop.ok = True
            prop.done.set()

    def _handle_commit(self, msg: MMonMon) -> None:
        if self.leader != msg.from_rank:
            return
        with self.mon.lock:
            pending = self._pending
            self._pending = None
        if pending is not None and pending[0] == msg.version:
            self.mon.apply_replicated(msg.version, pending[1])

    # ----------------------------------------------------------------- #
    # catch-up
    # ----------------------------------------------------------------- #
    def _send_sync(self, rank: int, their_lc: int) -> None:
        maps: Dict[int, dict] = {}
        with self.mon.lock:
            for e in range(their_lc + 1, self.mon.osdmap.epoch + 1):
                wire = self.mon.store.get_map(e)
                if wire is not None:
                    maps[e] = wire
            # auth state rides along: a rejoiner that catches up maps
            # but not the keyring could later win an election and
            # replicate its stale credentials over the quorum's
            keyring = self.mon.keyring.dump()
        if maps:
            self._send(rank, MMonMon(op="sync", from_rank=self.rank,
                                     maps=maps,
                                     value={"keyring": keyring}))

    def _handle_sync_req(self, msg: MMonMon) -> None:
        if self.is_leader():
            self._send_sync(msg.from_rank, msg.last_committed)

    def _handle_sync(self, msg: MMonMon) -> None:
        for e in sorted(msg.maps):
            self.mon.apply_replicated(e, msg.maps[e])
        if msg.value and "keyring" in msg.value:
            self.mon.install_keyring(msg.value["keyring"])

    # ----------------------------------------------------------------- #
    # leases + tick
    # ----------------------------------------------------------------- #
    def _handle_lease(self, msg: MMonMon) -> None:
        call_election = False
        with self.mon.lock:
            # a lease from a same-or-newer election epoch asserts that
            # mon's leadership — converges stragglers that missed the
            # victory (reference peons trust the paxos lease holder).
            # Never adopt a leader with OLDER data than ours: that
            # would fork the map lineage; force a new election our
            # newer data will win instead.
            if msg.epoch >= self.election_epoch and \
                    msg.from_rank != self.rank and \
                    msg.from_rank != self.leader:
                if msg.last_committed < self.mon.osdmap.epoch:
                    call_election = True
                else:
                    self.leader = msg.from_rank
                    self.election_epoch = msg.epoch
        if call_election:
            self.start_election()
            return
        with self.mon.lock:
            if msg.from_rank == self.leader:
                self._lease_expiry = time.monotonic() + \
                    self.mon.conf["mon_lease"] - \
                    self.mon.conf["mon_clock_drift_allowed"]
        if msg.last_committed > self.mon.osdmap.epoch:
            self._send(msg.from_rank, MMonMon(
                op="sync_req", from_rank=self.rank,
                last_committed=self.mon.osdmap.epoch))

    def tick(self) -> None:
        if self.n_mons == 1:
            return
        now = time.monotonic()
        if self.is_leader():
            # pace lease/commit broadcasts (reference
            # paxos_propose_interval batches proposal traffic)
            min_gap = self.mon.conf["paxos_propose_interval"]
            if now - getattr(self, "_last_lease_tx", 0.0) < min_gap:
                return
            self._last_lease_tx = now
            self._broadcast(MMonMon(
                op="lease", from_rank=self.rank,
                epoch=self.election_epoch,
                last_committed=self.mon.osdmap.epoch))
        elif self.in_quorum():
            if now > self._lease_expiry:
                self.log.dout(1, "leader lease expired, calling "
                              "election")
                self.start_election()
        else:
            # electing: at the end of the election period a candidate
            # with a majority of acks wins; otherwise the round restarts
            # (reference end_election_period).  A monitor that deferred
            # gives its candidate a further half period to declare
            # (reference Elector::defer resets its timer with extra time)
            period = self.mon.conf["mon_election_timeout"]
            with self.mon.lock:
                waited = now - self._election_started
                candidate = self._deferred_to is None
                won = candidate and len(self._acks) >= self.majority
            if won and waited > period:
                self._declare_victory()
            elif waited > (period if candidate else 1.5 * period):
                self.start_election()

    # ----------------------------------------------------------------- #
    def handle(self, msg: MMonMon) -> None:
        if msg.op in ("victory", "lease", "propose") and \
                msg.from_rank != self.rank and \
                msg.epoch > self.election_epoch:
            self._deposed_hint.set()
        handler = {
            "propose": self._handle_propose,
            "ack": self._handle_ack,
            "victory": self._handle_victory,
            "begin": self._handle_begin,
            "accept": self._handle_accept,
            "commit": self._handle_commit,
            "lease": self._handle_lease,
            "sync_req": self._handle_sync_req,
            "sync": self._handle_sync,
        }.get(msg.op)
        if handler is not None:
            handler(msg)
