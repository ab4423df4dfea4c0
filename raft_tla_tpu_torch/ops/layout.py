"""Packed-state layout: field widths and packing spec, computed from bounds.

Device representation (SURVEY.md §7.1, revised for SoA):  a state is a
struct-of-arrays pytree rather than one bit-packed word vector — XLA
vectorizes per-field int32 arrays well and the kernels stay readable —
with bit-packing used exactly where it is load-bearing:

  * **log entries** pack to one small int each (``entry_bits`` ≤ 16):
    ``term | etype | payload`` — so entry equality (LogMatching, the
    AppendEntries conflict test) is a single integer compare
    (reference entry schema: tlc_membership/raft.tla:115, 153-155).
  * **messages** pack to ``msg_words`` uint32 words per bag slot: a
    header word (type/term/src/dst/3 generic fields/entry-count) plus
    entry words.  Field-set identity (the follow-up CatchupRequest's
    *absent* mcommitIndex, raft.tla:762-771) is preserved by storing
    every generic field with a +1 offset so "absent" = -1 = stored 0.

State *identity* (VIEW semantics, raft.cfg:30) is established by a
64/128-bit fingerprint, not by canonical bytes:  the message bag is
hashed **commutatively** (sum over slots of ``count * mix(words)``), so
slot order — and even a message split across two slots — never affects
identity, and no canonical bag sort is required anywhere (the TypedBags
(+)/(-) semantics of raft.tla:226-231 are then free).  Symmetry
(raft.cfg:29) is the min of the fingerprint over server relabelings.

All widths derive from ModelConfig bounds; tests assert round-trip
identity against the oracle representation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..utils import lsr
from ..config import (MT_AEREQ, MT_AERESP, MT_CATREQ, MT_CATRESP, MT_COC,
                      MT_RVREQ, MT_RVRESP, ModelConfig)


def bits_for(maxval: int) -> int:
    """Bits needed to store values 0..maxval."""
    b = 1
    while (1 << b) <= maxval:
        b += 1
    return b


# Generic message-field mapping (type tag -> which oracle tuple positions
# land in generic fields a, b, c).  src/dst positions come from the oracle's
# own table (models/raft.py _SRC_DST) so there is one source of truth.
#   RVREQ   (t, term, lastLogTerm, lastLogIndex, src, dst)       a=llt b=lli
#   RVRESP  (t, term, granted, mlog, src, dst)                   a=granted
#   AEREQ   (t, term, prevIdx, prevTerm, entries, mcommit, s, d) a=pi b=pt c=mc
#   AERESP  (t, term, success, matchIdx, src, dst)               a=succ b=mi
#   CATREQ  (t, term, logLen, entries, mcommit, src, dst, rnds)  a=ll b=mc c=r
#   CATRESP (t, term, success, matchIdx, src, dst, roundsLeft)   a=s b=mi c=rl
#   COC     (t, term, madd, mserver, src, dst)                   a=madd b=msrv
_ABC_ENT = {
    MT_RVREQ:   dict(a=2, b=3, c=None, ent=None),
    MT_RVRESP:  dict(a=2, b=None, c=None, ent=3),
    MT_AEREQ:   dict(a=2, b=3, c=5, ent=4),
    MT_AERESP:  dict(a=2, b=3, c=None, ent=None),
    MT_CATREQ:  dict(a=2, b=4, c=7, ent=3),
    MT_CATRESP: dict(a=2, b=3, c=6, ent=None),
    MT_COC:     dict(a=2, b=3, c=None, ent=None),
}


def _msg_fields():
    from ..models.raft import _SRC_DST
    return {mt: dict(src=_SRC_DST[mt][0], dst=_SRC_DST[mt][1], **abc)
            for mt, abc in _ABC_ENT.items()}


MSG_FIELDS = _msg_fields()


@dataclass(frozen=True)
class Layout:
    cfg: ModelConfig

    # ---- dimensions -----------------------------------------------------
    @cached_property
    def S(self):
        return self.cfg.n_servers

    @cached_property
    def Lmax(self):
        """Max entries carried in one message (mentries/mlog ≤ one log:
        raft.tla:444 comment limits AE to ≤1; catchup sends SubSeq of a
        frontier log, ≤ MaxLogLength; RVResp mlog likewise)."""
        return self.cfg.bounds.max_log_length

    @cached_property
    def Lcap(self):
        """Max representable per-server log: catchup splice of a ≤L prefix
        with ≤L entries (HandleCatchupRequest raft.tla:734-736) = 2L; such
        states are generated+checked but never expanded (CONSTRAINT
        semantics, SURVEY §2.8)."""
        return self.cfg.log_capacity

    @cached_property
    def K(self):
        """Bag slots: distinct messages ≤ BagCardinality ≤ MaxInFlight,
        +1 headroom for the Send that overruns the bound before pruning."""
        return self.cfg.bag_capacity

    # ---- scalar field widths -------------------------------------------
    @cached_property
    def term_bits(self):
        # terms reach max_terms + 1 (Timeout from a max_terms state is
        # generated, then pruned by BoundedTerms)
        return bits_for(self.cfg.bounds.max_terms + 1)

    @cached_property
    def server_bits(self):
        return bits_for(max(self.S - 1, 1))

    @cached_property
    def value_bits(self):
        # entry payload: raw client value (raft.cfg:11 binds small ints)
        # or a config bitmask (S bits)
        return max(bits_for(max(self.cfg.values)), self.S)

    @cached_property
    def entry_bits(self):
        # term | etype(1) | payload ; 0 == "no entry" (real terms ≥ 1)
        return self.term_bits + 1 + self.value_bits

    @cached_property
    def field_bits(self):
        # generic message fields a/b/c, stored with +1 offset (absent=-1→0):
        # values span log indices (≤ Lcap+1), terms, server ids, rounds
        fmax = max(self.Lcap + 1, self.cfg.bounds.max_terms + 1, self.S,
                   self.cfg.num_rounds)
        return bits_for(fmax + 1)

    @cached_property
    def entlen_bits(self):
        return bits_for(self.Lmax)

    # ---- message word packing ------------------------------------------
    # word0 (header): mtype | mterm | msrc | mdst | a | b | c | entlen
    # word1..      : packed entries, entries_per_word per word
    @cached_property
    def header_shifts(self):
        shifts = {}
        cur = 0
        for name, width in (("mtype", 3), ("mterm", self.term_bits),
                            ("msrc", self.server_bits),
                            ("mdst", self.server_bits),
                            ("a", self.field_bits), ("b", self.field_bits),
                            ("c", self.field_bits),
                            ("entlen", self.entlen_bits)):
            shifts[name] = (cur, width)
            cur += width
        if cur > 32:
            raise ValueError(
                f"message header needs {cur} bits > 32; bounds too large "
                f"for the single-header-word packing (split packing TBD)")
        return shifts

    @cached_property
    def entries_per_word(self):
        return 32 // self.entry_bits

    @cached_property
    def msg_words(self):
        return 1 + (self.Lmax + self.entries_per_word - 1) \
            // self.entries_per_word

    # ---- fingerprint salts ---------------------------------------------
    @cached_property
    def n_hash_streams(self):
        return 2 if self.cfg.fp128 else 1

    def describe(self) -> str:
        return (f"Layout(S={self.S}, Lmax={self.Lmax}, Lcap={self.Lcap}, "
                f"K={self.K}, entry_bits={self.entry_bits}, "
                f"msg_words={self.msg_words})")

    def __post_init__(self):
        # packed entries live in int32 log lanes: 31 usable bits
        if self.entry_bits > 31:
            raise ValueError(
                f"entry_bits={self.entry_bits} exceeds the int32 log lane")
        _ = self.header_shifts  # validate eagerly


# ---------------------------------------------------------------------------
# Generic (numpy / int) bit-field helpers, with torch forms beside them.
# All shift amounts and masks are static Python ints.
# ---------------------------------------------------------------------------

def get_field(word, shift_width):
    shift, width = shift_width
    return (word >> shift) & ((1 << width) - 1)


def put_field(val, shift_width):
    shift, width = shift_width
    return (val & ((1 << width) - 1)) << shift


def get_field_t(word, shift_width):
    """Torch form of get_field on int32-carried u32 words: the shift is
    logical, so a field next to bit 31 reads its own bits only."""
    shift, width = shift_width
    return lsr(word, shift) & ((1 << width) - 1)


def put_field_t(val, shift_width):
    """Torch form of put_field: the int32 left shift keeps the u32 bit
    pattern, bit 31 included."""
    shift, width = shift_width
    return (val & ((1 << width) - 1)) << shift


def put_field_checked(val, shift_width, name="field"):
    """Host-side fail-loud variant: a value outside the field width means
    the state is un-representable under the configured bounds (possible if
    a user disables the stock constraints) — fault, don't alias."""
    shift, width = shift_width
    if not 0 <= val < (1 << width):
        raise OverflowError(
            f"message {name}={val} exceeds {width}-bit packing; state is "
            f"un-representable under the configured bounds")
    return val << shift


def pack_entry(lay: Layout, term, etype, payload):
    vb = lay.value_bits
    return (term << (1 + vb)) | (etype << vb) | payload


def unpack_entry(lay: Layout, e):
    vb = lay.value_bits
    return e >> (1 + vb), (e >> vb) & 1, e & ((1 << vb) - 1)


def entry_term(lay: Layout, e):
    return e >> (1 + lay.value_bits)


def entry_type(lay: Layout, e):
    return (e >> lay.value_bits) & 1


def entry_payload(lay: Layout, e):
    return e & ((1 << lay.value_bits) - 1)


def hash_salts(lay: Layout, n_words: int, stream: int = 0) -> np.ndarray:
    """Deterministic per-position 64-bit salts for the fingerprint mix."""
    rng = np.random.RandomState(0xC0FFEE + 7919 * stream)
    lo = rng.randint(0, 1 << 32, size=n_words, dtype=np.uint64)
    hi = rng.randint(0, 1 << 32, size=n_words, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo
