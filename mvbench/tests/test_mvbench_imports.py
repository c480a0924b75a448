"""What the chip runs imports no JAX and no JAX package, and the
reference imports nothing of the program: each shown in a process whose
import system refuses those top-level names (compared whole: the port's
name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

BLOCKER = '''
import importlib.abc, sys
BLOCKED = set(%r)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
'''


def run_blocked(blocked, body: str):
    code = BLOCKER % (tuple(blocked),) + body
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_harness_and_port_load_no_jax():
    out = run_blocked(("jax", "jaxlib", "flax", "multiverse_tpu"), '''
import pkgutil, importlib
import mvbench
from mvbench import run
for m in pkgutil.walk_packages(mvbench.__path__, "mvbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for kind in ("drivers", "metrics"):
    for f in (run.HERE / kind).glob("*.py"):
        if f.stem != "__init__":
            run.load_module(kind, f.stem)
tiny = dict(emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
            scene_conv_dim=8, scene_h=12, scene_w=16, compute_dtype="float32")
cells = {
    "flagship.decode_b16": (dict(tiny, beam_size=4),
        dict(pool=32, chunk=16, sample_per_chunk=2, min_pred_len=3,
             max_pred_len=5)),
}
for cell, (o, w) in cells.items():
    out = run.execute(cell, 5, 0.5, False, "cpu", 0.0, overrides=o,
                      workload=w)
    assert out["correct"], (cell, out["checks"])
print(run.blocked_modules())
''')
    assert out.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    run_blocked(("multiverse_torch", "jax", "jaxlib", "multiverse_tpu"), '''
import pkgutil, importlib
import torch
import mvbench.reference, mvbench.traffic, mvbench.arith
for pkg in (mvbench.reference, mvbench.traffic, mvbench.arith):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
import mvbench.weights
from mvbench.reference.plain import Model
model = dict(scene_h=12, scene_w=16, scene_class=5, scene_conv_dim=8,
             emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
             convlstm_kernel=3, scene_conv_kernel=3, use_scene_enc=True,
             use_gnn=True, use_single_decoder=False,
             scene_grid_strides=(2, 4), use_grids=(True, False))
w = mvbench.weights.make_weights(model, 3, "cpu")
ref = Model(w, model)
enc, enc_reg, scene = ref.encode(torch.zeros(2, 4, dtype=torch.long),
                                 torch.zeros(2, 4, 6, 8, 2),
                                 torch.zeros(2, 4, 12, 16, 5))
assert ref.class_paths(enc, scene, torch.zeros(2, dtype=torch.long),
                       torch.zeros(2, 3, 4, dtype=torch.long)).shape \\
    == (2, 3, 4, 48)
''')
