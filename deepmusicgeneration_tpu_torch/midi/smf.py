"""Standard MIDI File (SMF) reader/writer, dependency-free.

The reference delegates MIDI I/O to music21 (`core/encodings.py:88-177`);
music21 is not available here, so this module parses and emits SMF bytes
directly. Only the constructs the tokenizer needs are modelled: note on/off
pairing (with running status and vel-0 note-offs), program changes, tempo,
time/key signature, and end-of-track.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class MidiEvent:
    tick: int
    type: str           # 'note_on','note_off','program_change','tempo','time_signature','key_signature','control_change','other'
    channel: int = 0
    data: Tuple = ()    # type-specific payload


@dataclass
class MidiTrack:
    events: List[MidiEvent] = field(default_factory=list)
    name: str = ""

    def has_notes(self) -> bool:
        return any(e.type == "note_on" and e.data[1] > 0 for e in self.events)

    def channels(self) -> List[int]:
        return sorted({e.channel for e in self.events if e.type in ("note_on", "note_off")})

    def first_program(self, channel: Optional[int] = None) -> Optional[int]:
        for e in self.events:
            if e.type == "program_change" and (channel is None or e.channel == channel):
                return e.data[0]
        return None


@dataclass
class MidiFile:
    format: int = 1
    ticks_per_quarter: int = 480
    tracks: List[MidiTrack] = field(default_factory=list)


def _read_vlq(data: bytes, i: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, i


def _write_vlq(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


def parse_midi_bytes(data: bytes) -> MidiFile:
    if data[:4] != b"MThd":
        raise ValueError("not a standard MIDI file (missing MThd)")
    hdr_len = struct.unpack(">I", data[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        # SMPTE division: convert to an effective tick/quarter assuming 120bpm
        fps = 256 - (division >> 8)
        tpf = division & 0xFF
        tpq = int(fps * tpf / 2)  # 0.5s per quarter at 120bpm
    else:
        tpq = division
    mf = MidiFile(format=fmt, ticks_per_quarter=max(tpq, 1))
    i = 8 + hdr_len
    for _ in range(ntrks):
        if i + 8 > len(data):
            break
        if data[i:i + 4] != b"MTrk":
            # skip unknown chunk
            chunk_len = struct.unpack(">I", data[i + 4:i + 8])[0]
            i += 8 + chunk_len
            continue
        trk_len = struct.unpack(">I", data[i + 4:i + 8])[0]
        trk = _parse_track(data[i + 8:i + 8 + trk_len])
        mf.tracks.append(trk)
        i += 8 + trk_len
    return mf


def _parse_track(data: bytes) -> MidiTrack:
    trk = MidiTrack()
    i = 0
    tick = 0
    running_status = 0
    n = len(data)
    while i < n:
        delta, i = _read_vlq(data, i)
        tick += delta
        status = data[i]
        if status & 0x80:
            i += 1
            if status < 0xF0:
                running_status = status
        else:
            status = running_status
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90:
            note, vel = data[i], data[i + 1]
            i += 2
            if vel == 0:
                trk.events.append(MidiEvent(tick, "note_off", ch, (note, 0)))
            else:
                trk.events.append(MidiEvent(tick, "note_on", ch, (note, vel)))
        elif kind == 0x80:
            note, vel = data[i], data[i + 1]
            i += 2
            trk.events.append(MidiEvent(tick, "note_off", ch, (note, vel)))
        elif kind == 0xC0:
            trk.events.append(MidiEvent(tick, "program_change", ch, (data[i],)))
            i += 1
        elif kind == 0xD0:  # channel pressure
            i += 1
        elif kind in (0xA0, 0xB0, 0xE0):
            if kind == 0xB0:
                trk.events.append(MidiEvent(tick, "control_change", ch, (data[i], data[i + 1])))
            i += 2
        elif status == 0xFF:
            meta_type = data[i]
            i += 1
            length, i = _read_vlq(data, i)
            payload = data[i:i + length]
            i += length
            if meta_type == 0x51 and length == 3:
                us_per_quarter = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                trk.events.append(MidiEvent(tick, "tempo", 0, (us_per_quarter,)))
            elif meta_type == 0x58 and length >= 2:
                trk.events.append(MidiEvent(tick, "time_signature", 0, (payload[0], 2 ** payload[1])))
            elif meta_type == 0x59 and length >= 2:
                sharps = struct.unpack(">b", payload[0:1])[0]
                trk.events.append(MidiEvent(tick, "key_signature", 0, (sharps, payload[1])))
            elif meta_type == 0x03:
                try:
                    trk.name = payload.decode("latin-1").strip("\x00").strip()
                except Exception:
                    pass
            elif meta_type == 0x2F:
                break
        elif status in (0xF0, 0xF7):  # sysex
            length, i = _read_vlq(data, i)
            i += length
        else:
            # unknown status byte — abort this track defensively
            break
    return trk


def parse_midi_file(path) -> MidiFile:
    with open(path, "rb") as f:
        return parse_midi_bytes(f.read())


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def render_midi_bytes(mf: MidiFile) -> bytes:
    out = [b"MThd", struct.pack(">IHHH", 6, mf.format, len(mf.tracks), mf.ticks_per_quarter)]
    for trk in mf.tracks:
        out.append(_render_track(trk))
    return b"".join(out)


_STATUS = {"note_on": 0x90, "note_off": 0x80, "program_change": 0xC0, "control_change": 0xB0}


def _render_track(trk: MidiTrack) -> bytes:
    body = bytearray()
    last_tick = 0
    events = sorted(trk.events, key=lambda e: e.tick)
    if trk.name:
        name = trk.name.encode("latin-1", "replace")
        body += _write_vlq(0) + bytes([0xFF, 0x03]) + _write_vlq(len(name)) + name
    for e in events:
        delta = e.tick - last_tick
        last_tick = e.tick
        body += _write_vlq(delta)
        if e.type == "tempo":
            us = e.data[0]
            body += bytes([0xFF, 0x51, 0x03, (us >> 16) & 0xFF, (us >> 8) & 0xFF, us & 0xFF])
        elif e.type == "time_signature":
            num, denom = e.data
            dd = max(denom, 1).bit_length() - 1
            body += bytes([0xFF, 0x58, 0x04, num, dd, 24, 8])
        elif e.type == "key_signature":
            sharps, minor = e.data
            body += bytes([0xFF, 0x59, 0x02, sharps & 0xFF, minor])
        elif e.type in _STATUS:
            body += bytes([_STATUS[e.type] | (e.channel & 0x0F)]) + bytes(e.data)
        else:
            # unknown event types are dropped on write
            body = body[:-len(_write_vlq(delta))]
    body += _write_vlq(0) + bytes([0xFF, 0x2F, 0x00])
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def write_midi_file(mf: MidiFile, path) -> None:
    with open(path, "wb") as f:
        f.write(render_midi_bytes(mf))
