"""The port's copies of the JAX package's host code stay equal to their
originals.

The port copies the node's host planes (``util``, ``trace``, ``xdr``, the
crypto helpers, ``database``, ``scp``, ``herder``, ``tx``, ``ledger``, the
bucket list, ``overlay``, ``history``, ``invariant``, ``ingest``,
``process``, ``main``, ``simulation``), the static-analysis gate
(``analysis``), the fuzzer (``main/fuzz.py``), the chaos scenarios
(``scenarios``) and four C engines from
``stellar_tpu/`` into ``stellar_tpu_torch/``.  Each copy is byte for byte
its original, or one of the named seams below, each with its reason: a hand
edit of a copy breaks the ledger hashes in ways that are hard to trace
(tests/test_torch_node.py holds the hashes).

The one other difference: where an original's comment or docstring names
its development history (an issue, PR or round number, or a path on the
machine it was written on), the copy's words leave that out.  Those hunks
are listed in ``RETAGGED``, each pinned by the digests of the original's
lines and the copy's, so any other change on either side fails the test.  To
take in a change of such an original, copy it again, leave out its tags, and
put the new digests here (``_hunks`` prints them).

Ported, not copied, and so out of this test: ``parallel/`` (the verify
plane's device mesh, on ``torch.device`` instead of ``jax.sharding``).  It
and the port's own modules at the same paths (``crypto/sigbackend.py``,
``crypto/sodium.py``, ``crypto/sigcache.py``, ``bucket/hashplane.py``,
``native/__init__.py``, ``native/sighash.c``) are held against the JAX
package by their own tests (``tests/test_torch_mesh.py`` for the mesh).
"""

from __future__ import annotations

import difflib
import filecmp
import hashlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "stellar_tpu")
PORT = os.path.join(REPO, "stellar_tpu_torch")

# subpackages copied whole
WHOLE = ("util", "trace", "xdr", "crypto/aggregate", "database", "scp", "herder",
         "tx", "ledger", "overlay", "history", "invariant", "ingest", "process",
         "simulation", "analysis", "scenarios")
# modules copied one by one out of subpackages the port shares
SINGLE = (
    "crypto/__init__.py", "crypto/sha.py", "crypto/strkey.py", "crypto/base58.py",
    "crypto/ecdh.py", "crypto/keys.py",
    "bucket/__init__.py", "bucket/bucket.py", "bucket/bucketlist.py",
    "bucket/futurebucket.py", "bucket/manager.py", "bucket/mergeworker.py",
    "main/__init__.py", "main/application.py", "main/config.py",
    "main/persistentstate.py", "main/externalqueue.py", "main/commandhandler.py",
    "main/selfcheck.py", "main/cli.py", "main/fuzz.py",
    "native/cxdrpack.c", "native/applycore.c", "native/bucketmerge.c", "native/halfagg.c",
)
# the copies whose code differs from the original, and why
SEAMS = {
    "crypto/__init__.py": "exports the gpu backend (GpuSigBackend, DeviceStallError);"
                          " there is no TpuSigBackend",
    "crypto/keys.py": "signs and eagerly verifies with ref25519 where libsodium does not"
                      " load, and counts those verifies (stats)",
    "main/config.py": 'SIGNATURE_BACKEND is "gpu" (the default) or "cpu"; GPU_CPU_CUTOVER;'
                      " SIG_DEVICE, whose type SIG_MESH's devices take",
    "main/application.py": "make_backend(sig_mesh=SIG_MESH, device=SIG_DEVICE,"
                           " cpu_cutover=GPU_CPU_CUTOVER); the device bucket-hash backend"
                           " resolved (built) at boot",
    "main/cli.py": "no JAX platform latch",
    "main/commandhandler.py": "/profiler runs torch.profiler",
    "tx/testutils.py": "imports the xdr package relatively; get_test_config defaults to"
                       " the gpu backend and puts its directories under the temp dir,"
                       " named by process",
    "analysis/core.py": "_relpath_of scopes rules by the path after the last stellar_tpu"
                        " or stellar_tpu_torch segment, so the path-scoped rules see the"
                        " port's files",
    "analysis/__main__.py": "prog, description and default path name the port's package",
    "analysis/__init__.py": "the docstring names the port's package, its CLI and its test",
    "scenarios/scenario.py": 'signature_backend None keeps the port\'s test default ("gpu",'
                             " on the card); gpu_cpu_cutover sets GPU_CPU_CUTOVER; sig_device"
                             " sets SIG_DEVICE, so a test runs the gpu class on the plain"
                             " versions",
    "scenarios/matrix.py": "byzantine_flood_tpu is byzantine_flood_gpu: the gpu backend at"
                           " cutover 0, at the same flood rates; run_matrix takes a"
                           " signature_backend for every node (the CLI's flag)",
    "scenarios/killsweep.py": "imports the kill-point modules relatively; the child runs"
                              " -m stellar_tpu_torch.scenarios on the test config's"
                              " backend, or on the one run_kill_sweep is given (the"
                              " tests ask for the cpu backend)",
    "scenarios/faults.py": "imports the xdr package relatively",
    "scenarios/__main__.py": "prog and usage name the port's package; --signature-backend"
                             " sets every node's backend (the tests ask for cpu)",
    "trace/tracer.py": "record() takes spans stamped elsewhere (the verify plane's C host"
                       " stage) and py.gc spans record the collector's passes, both on"
                       " real clocks only",
}
# the only files a seam may be (the composition root's seams, and the tracer)
SEAM_FILES = {
    "crypto/__init__.py", "crypto/keys.py", "crypto/ecdh.py", "overlay/peer.py",
    "main/config.py", "main/application.py", "main/cli.py", "main/commandhandler.py",
    "tx/testutils.py", "analysis/core.py", "analysis/__main__.py", "analysis/__init__.py",
    "scenarios/scenario.py", "scenarios/matrix.py", "scenarios/killsweep.py",
    "scenarios/faults.py", "scenarios/__main__.py", "trace/tracer.py",
}
# comment and docstring hunks whose words leave out the original's
# development-history tags: "<original lines' digest>:<copy lines' digest>"
RETAGGED = {
    "analysis/crules.py": {'2c9c53a4c5b2:ff206f5ae51c'},
    "analysis/rules.py": {'034f3712d04f:43529df5ad26', '120b3613b8f0:a50987a7092d', '69e47fc8c006:fb3ef9b822c0', '78f5df410bd6:4e0c7bf9720f', '90b04b7d641b:ac75964f9b70', 'b12a7a41f3bf:d90c10e05534', 'bc5caa7667e1:621d49d3c82b', 'c3b3165f2e13:b2d8c397cad6', 'd63ddba44a08:9703fc71c6f8', 'd6623a7af2d8:a2d970454ac2', 'e4cc11182592:4e4ec79d1bad', 'edf80176b3de:f47ae3d1c494', 'f2893ea9895c:020b47e849bf'},
    "bucket/bucket.py": {'8298ae39d33b:225694e820c2', 'f198db7b8404:07690910ca12'},
    "bucket/futurebucket.py": {'6d5868cfdfdb:2e2585dbc47b'},
    "bucket/manager.py": {'38ade84d42e7:44708279299f'},
    "bucket/mergeworker.py": {'5d5531c5f470:e8aac983521a'},
    "crypto/aggregate/halfagg.py": {'c96c7d8a64fb:8fdc194fd3f0'},
    "crypto/aggregate/scheme.py": {'d68de2b30636:cc0ac74027f1'},
    "database/database.py": {'c970118edfb4:b76c29cf7181'},
    "herder/herder.py": {'2ce4867e4c76:d36b7b15a158', '34a0d5fb9f52:f50ff2322e1c', '3c11acf9e25f:e2b7773fc323', '4a1677a48e3a:ee866507bd03', 'ae70742e4a71:f11b16255ca4', 'd8b3a24fa5d6:d8b04fc74497', 'e48713a7bbe1:84fee94b3766', 'ebfb06b6e503:c11ad67c56f5'},
    "herder/pendingenvelopes.py": {'162f955e0f75:047d894cfef1', 'c6ad2f72603b:9775272175a4'},
    "ingest/plane.py": {'08199b0b3939:edb246c96550'},
    "invariant/manager.py": {'36439325f2d5:9c638383bc8f'},
    "ledger/accountframe.py": {'115420cf0f57:5138033017dc', 'e289eae61c9e:1967620ff156'},
    "ledger/applysched.py": {'b7fbef071677:c122594e9ebd'},
    "ledger/delta.py": {'d744ca37daa2:f4e96d800fef'},
    "ledger/entryframe.py": {'9ad5d4412579:d3565c0dfd29'},
    "ledger/framecontext.py": {'5f7c79c56dcf:0b0119c1aa2f', 'd0cb5cd461ee:096458434901', 'e2e0846283c0:116858c14c00'},
    "ledger/manager.py": {'ef603cdc5d95:06d4216edf0e'},
    "ledger/storebuffer.py": {'10bde40008cc:70b2c17dfa78'},
    "native/bucketmerge.c": {'d54cfda7da93:6568b123a651'},
    "native/cxdrpack.c": {'77f68bf12642:e1b7f7a3a70c'},
    "native/halfagg.c": {'482e030fcf21:9ad2ac1392f3'},
    "overlay/floodgate.py": {'69b2c3593116:889844be0280'},
    "overlay/itemfetcher.py": {'fa8c822799c3:4702b0bf2e92'},
    "overlay/loopback.py": {'bdefdb78930a:b4e2c1da8105'},
    "overlay/manager.py": {'d54e1136c05d:0e5436186964'},
    "overlay/peer.py": {'6ed210093e05:5810e9377a92', 'f9a6b4a0d732:e26fdb4db768'},
    "overlay/sendqueue.py": {'0068c751f562:fb37ea0597ad'},
    "scenarios/scoreboard.py": {'4d85cdc2da8f:811c33403739', '5fa9dcb8ef02:aaad5ae6f99c', '8c5a6ff0d922:72ef5f2681cd', '9e1c005b2391:c78dba0520ff', 'c43410033b6f:af11594035fd', 'e14993cefdd9:55232bf070c9', 'e956d0890e96:3a421835bc01'},
    "simulation/simulation.py": {'71bc79a08271:f79ea4283d07'},
    "simulation/topologies.py": {'2f6983118cbc:e9dd0d6de11c', 'd1309adb92a6:a4daf01d9d3a'},
    "util/metrics.py": {'52328a194280:88565b7bbe1b', '6d1bd0abcb4d:fa2e079c48e5'},
    "xdr/base.py": {'ea47e62fa215:c0cc68215e86'},
}


def _copied():
    rels = set(SINGLE)
    for pkg in WHOLE:
        for name in os.listdir(os.path.join(JAX, pkg)):
            if name.endswith(".py"):
                rels.add(f"{pkg}/{name}")
    return sorted(rels)


COPIED = _copied()


def _digest(lines):
    return hashlib.sha256(b"".join(lines)).hexdigest()[:12]


def _hunks(orig, copy):
    """The hunks where the copy's lines differ from the original's, as
    "<original's digest>:<copy's digest>"."""
    a = open(orig, "rb").read().splitlines(keepends=True)
    b = open(copy, "rb").read().splitlines(keepends=True)
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return {f"{_digest(a[i1:i2])}:{_digest(b[j1:j2])}"
            for tag, i1, i2, j1, j2 in ops if tag != "equal"}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_the_original_or_a_named_seam(rel):
    orig, copy = os.path.join(JAX, rel), os.path.join(PORT, rel)
    assert os.path.exists(orig), f"{rel}: no original in the JAX package"
    assert os.path.exists(copy), f"{rel}: not copied into the port"
    same = filecmp.cmp(orig, copy, shallow=False)
    if rel in SEAMS:
        assert not same, f"{rel} is listed as a seam but is an exact copy"
    elif rel in RETAGGED:
        assert _hunks(orig, copy) == RETAGGED[rel], (
            f"{rel} differs from stellar_tpu/{rel} outside its retagged comments:"
            " make it a copy again, or name it a seam with its reason"
        )
    else:
        assert same, (
            f"{rel} differs from stellar_tpu/{rel}: make it a copy again,"
            " or name it a seam with its reason"
        )


def test_seams_are_the_composition_roots_files():
    assert set(SEAMS) <= SEAM_FILES
    assert set(SEAMS) <= set(COPIED)
    assert all(SEAMS.values())
    assert set(RETAGGED) <= set(COPIED) - set(SEAMS)


def test_nothing_left_out_was_copied():
    """``parallel/`` is the one package the port rewrites rather than
    copies: its module exists in both packages, and the port's is its own
    (it names ``torch.device``, never ``jax``)."""
    for rel in ("parallel/mesh.py",):
        orig, port = os.path.join(JAX, rel), os.path.join(PORT, rel)
        assert os.path.exists(orig) and os.path.exists(port), rel
        assert not filecmp.cmp(orig, port, shallow=False), rel
        assert rel not in COPIED, rel
        src = open(port).read()
        assert "import jax" not in src and "torch.device" in src, rel
