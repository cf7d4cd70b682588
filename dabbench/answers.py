"""The two sides that answer a call: the program under test, or the plain
reference's answers made in bulk. An entry adapter (``entries/<name>.py``)
has a function for each side, named by its ``SIDE``.

``Program`` holds the program, ``viterbi_tpu_torch``, and the device it
is asked to use (None: its own default, the card). ``Table`` decodes every
input of the workload at once with the plain reference (``reference/``):
with 8-bit soft symbols its answers are what the program must give; with
fewer it is the control, a decoder that keeps less of each symbol, put in
the program's place.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import rs as ref_rs
from .reference import viterbi as ref_vit

#: what an export's output buffer holds before the call
SENTINEL = 0x5A


class Program:
    """The system under test."""
    SIDE = "program"

    def __init__(self, cpu: bool):
        self.api = importlib.import_module("viterbi_tpu_torch")
        self.device = "cpu" if cpu else None
        self._modules: dict = {}
        if cpu:
            self.api.initialize(device="cpu")

    def module(self, name: str):
        """A module of the program, by its dotted name."""
        mod = self._modules.get(name)
        if mod is None:
            mod = self._modules[name] = importlib.import_module(name)
        return mod


class Table:
    """Every answer of the workload's inputs, made by the plain reference
    on ``device`` from symbols cut to ``soft_bits`` bits."""
    SIDE = "control"

    def __init__(self, pools: dict, device, soft_bits: int = 8):
        self.device, self.soft_bits = device, soft_bits
        self.frames, self.sf = {}, {}
        for name, pool in pools.items():
            syms = torch.from_numpy(pool.symbols).to(device)
            if soft_bits < 8:
                syms = ref_vit.soft_bits(syms, soft_bits)
            rows = syms.shape[0]
            flat = syms.reshape(-1, syms.shape[-1])
            dec = ref_vit.decode(flat, pool.framebits)
            del syms, flat
            if pool.superframes:
                sf = dec.reshape(rows, -1)
                errors, audio, n_ok = ref_rs.check_superframes(
                    sf, pool.rs_dims)
                self.sf[name] = (sf.cpu().numpy(), errors.cpu().numpy(),
                                 audio.cpu().numpy(), n_ok.cpu().numpy())
                dec = dec.reshape(rows, -1, pool.framebits // 8)
            self.frames[name] = dec.cpu().numpy()

    def superframes(self, name):
        """The decoded superframes of a pool as kernel I receives them."""
        return self.sf[name][0]

    def checked(self, name):
        """(errors, audio, n_ok) of RScheckSuperframe on each decoded
        superframe of a pool."""
        return self.sf[name][1:]

    def check(self, sf: np.ndarray, rs_dims: int):
        """(errors, audio, n_ok) of RScheckSuperframe on one superframe's
        bytes."""
        t = torch.from_numpy(np.ascontiguousarray(sf, np.uint8)[None])
        errors, audio, n_ok = ref_rs.check_superframes(t.to(self.device),
                                                       rs_dims)
        return int(errors[0]), audio[0].cpu(), int(n_ok[0])

    @staticmethod
    def export(audio, errors, n_ok, rs_dims):
        """(return code, output buffer) of the RS export: what it writes
        over a buffer of ``SENTINEL`` bytes, the -1 prefix write
        included."""
        before = torch.full((rs_dims * ref_rs.KK,), SENTINEL,
                            dtype=torch.uint8)
        audio = audio if torch.is_tensor(audio) else torch.from_numpy(audio)
        return errors, ref_rs.export_buffer(audio, errors, n_ok, rs_dims,
                                            before).numpy()
