"""Offline dense scoring through FTCN-TT: ``dense.py``'s traffic and driver,
over ``ClipScorer(arch="ftcn_tt")``.

The mix's parameters, the tracks made from the seed, the set-up and the
measured window are ``dense.py``'s, taken by import: this module loads its
own copy of that module and hands it the FTCN's program builder and work
count, so the window's record (``"kind": "dense"``, read by the dense
metrics) carries FTCN-TT's FLOPs. The output check is this module's: the
same sample of neighbouring windows as ``dense.py`` draws, recomputed by
``reference/ftcn.py``, the gaps taken against ``head_fc``'s weight and the
reference's normed cls token (``lib/check.py``).
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import List, Tuple

import numpy as np
import torch

from portbench.lib import flops
from portbench.lib.check import signed_gaps, stratified_pick
from portbench.lib.ftcn_flops import ftcn_flops
from portbench.lib.ftcn_weights import make_ftcn_params
from portbench.lib.program import DTYPES, VARIANTS, i3d_config
from portbench.lib.registry import load_module
from portbench.reference.ftcn import logits_and_features, net_spec

dense = load_module(Path(__file__).with_name("dense.py"), "portbench_kind_dense_for_ftcn")


def build_ftcn_scorer(config: dict, seed: int, device, variant=None):
    """→ (scorer, the weights it was handed, the layer shapes): the port's
    ``ClipScorer`` of the configuration's ``arch`` over the seeded weights."""
    from stdd_torch.runtime.classifier import ClipScorer

    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the program has {VARIANTS}")
    model = config["model"]
    spec = net_spec(model, config["head"])
    params = make_ftcn_params(spec, seed, device)
    serving = config["serving"]
    scorer = ClipScorer(params, cfg=i3d_config(model), dtype=DTYPES[serving["dtype"]],
                        upload_format=serving["upload_format"], device=device,
                        int8=variant == "int8", arch=model["arch"])
    return scorer, params, spec


# dense.py's Run builds its program and counts its work through these two names
dense.build_scorer = build_ftcn_scorer
dense.flops = SimpleNamespace(i3d_flops=ftcn_flops, k1_bytes_per_frame=flops.k1_bytes_per_frame)


class Run(dense.Run):
    def check(self) -> List[Tuple[str, float, float]]:
        """``dense.Run.check``'s numbers (``logit_gap``, ``step_gap``) for
        FTCN-TT: the program freed, the pairs recomputed by the reference."""
        del self.scorer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        pairs = [(r, s) for r, (k, p) in enumerate(self.scored) for s in range(len(p) - 1)]
        rng = np.random.default_rng([self.seed & 0xFFFF_FFFF_FFFF_FFFF, dense.SALT_CHECK])
        windows, probs = [], []
        for r, s in stratified_pick(pairs, self.mix["check_pairs"], rng):
            k, p = self.scored[r]
            frames, boxes, lm5 = self.tracks[k]
            for j in (s, s + 1):
                a = self.starts[k][j]
                windows.append((frames[a:a + self.T], boxes[a:a + self.T], lm5[a:a + self.T]))
                probs.append(float(p[j]))
        eps = self.cell.config["model"]["bn_eps"]
        ref_logits, ref_feats = logits_and_features(self.params, self.spec, windows, eps,
                                                    self.device)
        d = signed_gaps(np.asarray(probs), ref_logits[:, 0], ref_feats,
                        self.params["head.head_fc.weight"])
        self.gaps, self.steps = np.abs(d), np.abs(d[1::2] - d[0::2])
        lim = self.cell.limits
        return [("logit_gap", float(self.gaps.max()), lim["logit_gap"]),
                ("step_gap", float(self.steps.max()), lim["step_gap"])]
