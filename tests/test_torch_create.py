"""agc_tpu_torch create/append (device='cpu', the kernels' plain versions)
against agc_tpu's create/append: equal splitter sets, archives equal
stream for stream and part for part, byte-equal extraction with agc_tpu's
Decompressor, and a port that imports neither jax nor agc_tpu. Each
package gets its own CompressorParams.

These tests pin AGC_TPU_DEVICE_MATCH=0 on both packages; the estimate
prepass, which both run under the default auto gate, is held against
agc_tpu in test_torch_device_match.py.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from agc_tpu.core.archive import ArchiveReader
from agc_tpu.core.compressor import CompressorParams as TpuParams
from agc_tpu.core.compressor import append_archive as tpu_append
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu.core.decompressor import Decompressor
from agc_tpu_torch.core.compressor import CompressorParams, append_archive, create_archive

from util import make_collection, mutate, random_seq, write_fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _splitters(path):
    r = ArchiveReader(path)
    try:
        data, _n = r.get_part("splitters", 0)
    finally:
        r.close()
    return set(np.frombuffer(data, dtype="<u8").tolist())


def assert_same_archive(a, b):
    """Stream-for-stream, part-for-part equality (physical part order
    depends on when the async store ran, so raw bytes may differ)."""
    ra, rb = ArchiveReader(a), ArchiveReader(b)
    try:
        assert set(ra.stream_names()) == set(rb.stream_names())
        for nm in ra.stream_names():
            assert ra.n_parts(nm) == rb.n_parts(nm), nm
            for i in range(ra.n_parts(nm)):
                assert ra.get_part(nm, i) == rb.get_part(nm, i), (nm, i)
    finally:
        ra.close()
        rb.close()


def _tpu_params(params):
    """The same parameters as agc_tpu's CompressorParams."""
    return TpuParams(**vars(params))


def _fasta_body(path, contig):
    seqs, name = {}, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:]
                seqs[name] = []
            else:
                seqs[name].append(line)
    return "".join(seqs[contig]).encode()


def assert_extracts(archive, files, contigs):
    d = Decompressor(archive)
    try:
        for sample, path in files:
            for c in contigs:
                assert d.get_contig_seq(sample, c) == _fasta_body(path, c), (sample, c)
    finally:
        d.close()


@pytest.fixture
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")


@pytest.mark.parametrize("profile", ["zstd", "tpu-rans"])
@pytest.mark.parametrize("layout", ["multi", "single"])
def test_create_matches_agc_tpu(tmp_path, device_match_off, profile, layout):
    lens = (60000, 40000) if layout == "multi" else (90000,)
    files = make_collection(tmp_path, random.Random(7), n_samples=2, contig_lens=lens)
    paths = [p for _, p in files]
    params = CompressorParams(segment_size=4000, profile=profile)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, params, device="cpu")
    tpu_create(ref, paths, _tpu_params(params))
    assert _splitters(ours) == _splitters(ref)
    assert len(_splitters(ours)) > 2
    assert_same_archive(ours, ref)
    contigs = [f"c{i + 1}" for i in range(len(lens))]
    assert_extracts(ours, files, contigs)


def test_create_default_params_concatenated(tmp_path, device_match_off):
    """Default params (segment 60000) and the -c mode, which scans through
    the port's batcher in contig batches."""
    files = make_collection(tmp_path, random.Random(3), n_samples=2,
                            contig_lens=(130000, 20000))
    paths = [p for _, p in files]
    for params in (CompressorParams(),
                   CompressorParams(concatenated_genomes=True, segment_size=3000)):
        ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
        create_archive(ours, paths, params, device="cpu")
        tpu_create(ref, paths, _tpu_params(params))
        assert_same_archive(ours, ref)


def test_append_round_trip(tmp_path, device_match_off):
    rng = random.Random(11)
    files = make_collection(tmp_path, rng, n_samples=1, contig_lens=(50000,))
    base = [p for _, p in files]
    seq = _fasta_body(files[0][1], "c1").decode()
    extra = str(tmp_path / "extra.fa")
    write_fa(extra, [("c1", mutate(rng, seq, 150, 10)), ("c2", random_seq(rng, 3000))])
    params = CompressorParams(segment_size=3000)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, base, params, device="cpu")
    tpu_create(ref, base, _tpu_params(params))
    ours2, ref2 = str(tmp_path / "port2.agc"), str(tmp_path / "tpu2.agc")
    append_archive(ours, ours2, [extra], params, device="cpu")
    tpu_append(ref, ref2, [extra], _tpu_params(params))
    assert_same_archive(ours2, ref2)
    assert_extracts(ours2, [("extra", extra)], ["c1", "c2"])
    assert_extracts(ours2, files, ["c1"])


@pytest.mark.parametrize("sample_name", [None, "given"])
def test_add_sample_file_matches_agc_tpu(tmp_path, device_match_off, sample_name):
    """The one-file entry, the sample named from its path or given: both
    engines' archives equal part for part."""
    from agc_tpu.core.compressor import Compressor as TpuCompressor
    from agc_tpu_torch.core.compressor import Compressor

    files = make_collection(tmp_path, random.Random(17), n_samples=2,
                            contig_lens=(40000, 9000))
    ref = files[0][1]
    params = CompressorParams(segment_size=3000)
    ours, tpu = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    for comp in (Compressor(ours, params, reference_file=ref, device="cpu"),
                 TpuCompressor(tpu, _tpu_params(params), reference_file=ref)):
        for _name, path in files:
            assert comp.add_sample_file(path, sample_name and f"{sample_name}-{_name}")
        comp.close()
    assert_same_archive(ours, tpu)
    named = [((sample_name and f"{sample_name}-{n}") or n, p) for n, p in files]
    assert_extracts(ours, named, ["c1", "c2"])


def test_port_never_imports_jax(tmp_path):
    files = make_collection(tmp_path, random.Random(5), n_samples=1,
                            contig_lens=(30000,))
    out = str(tmp_path / "x.agc")
    code = (
        "import sys\n"
        "import agc_tpu_torch\n"
        "from agc_tpu_torch.core.compressor import CompressorParams, create_archive\n"
        "from agc_tpu_torch.cli.main import main\n"
        "from agc_tpu_torch.core import ArchiveReader, Decompressor\n"
        f"create_archive({out!r}, {[p for _, p in files]!r}, "
        "CompressorParams(segment_size=3000), device='cpu')\n"
        f"Decompressor({out!r}).get_contig_seq('s0', 'c1')\n"
        f"assert ArchiveReader({out!r}).get_part('splitters', 0)[1] > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
    assert os.path.getsize(out) > 0


_BLOCK_REFERENCE = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('agc_tpu', 'jax', 'jaxlib'):\n"
    "            raise ImportError(f'blocked: {name}')\n"
    "sys.meta_path.insert(0, _Block())\n"
)


def test_port_stands_alone(tmp_path):
    """With agc_tpu and jax blocked by a sys.meta_path finder, the port
    imports, creates on the CPU (default mode, -a -f, anchor mode with the
    match layer's tables and the forced estimate prepass, and tpu-rans with
    the forced device coder), and extracts byte-equal through its own
    AGCFile and its own CLI (getcol)."""
    files = make_collection(tmp_path, random.Random(13), n_samples=1,
                            contig_lens=(30000, 9000))
    out = str(tmp_path / "x.agc")
    out_af = str(tmp_path / "af.agc")
    out_match = str(tmp_path / "match.agc")
    out_rans = str(tmp_path / "rans.agc")
    got_dir = tmp_path / "got"
    got_dir.mkdir()
    code = _BLOCK_REFERENCE + (
        "import agc_tpu_torch\n"
        "from agc_tpu_torch.core.compressor import CompressorParams, create_archive\n"
        "from agc_tpu_torch.cli.main import main\n"
        f"create_archive({out!r}, {[p for _, p in files]!r}, "
        "CompressorParams(segment_size=3000), device='cpu')\n"
        f"create_archive({out_af!r}, {[p for _, p in files]!r}, CompressorParams("
        "segment_size=3000, adaptive_compression=True, fallback_frac=0.05), device='cpu')\n"
        "import os\n"
        "os.environ['AGC_TPU_DEVICE_MATCH'] = '1'\n"
        "os.environ['AGC_TPU_DEVICE_LZ'] = '1'\n"
        f"t = create_archive({out_match!r}, {[p for _, p in files]!r}, CompressorParams("
        "segment_size=3000, lz_mode='anchor'), device='cpu')\n"
        "assert t.times['device_lz_tables'] > 0 and t.units['device_match'] > 0\n"
        "del os.environ['AGC_TPU_DEVICE_MATCH'], os.environ['AGC_TPU_DEVICE_LZ']\n"
        "os.environ['AGC_TPU_RANS_DEVICE'] = '1'\n"
        f"create_archive({out_rans!r}, {[p for _, p in files]!r}, CompressorParams("
        "segment_size=3000, profile='tpu-rans'), device='cpu')\n"
        "del os.environ['AGC_TPU_RANS_DEVICE']\n"
        f"for other in ({out_af!r}, {out_match!r}, {out_rans!r}):\n"
        "    with agc_tpu_torch.AGCFile(other) as agc:\n"
        "        assert agc.GetCtgSeq('s0', 'c1') == agc_tpu_torch.AGCFile("
        f"{out!r}).GetCtgSeq('s0', 'c1')\n"
        f"with agc_tpu_torch.AGCFile({out!r}) as agc:\n"
        "    print(agc.GetCtgSeq('s0', 'c2'))\n"
        f"assert main(['getcol', '-l', '70', '-o', {str(got_dir)!r}, {out!r}]) == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('agc_tpu', 'jax')]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().encode() == _fasta_body(files[1][1], "c2")
    for sample, path in files:
        with open(path, "rb") as a, open(got_dir / f"{sample}.fa", "rb") as b:
            assert a.read() == b.read(), sample


@pytest.mark.parametrize("workers", ["thread", "process", "torchdist"])
def test_port_stands_alone_sharded(tmp_path, workers):
    """With agc_tpu and jax blocked in this process AND in every process it
    starts (a sitecustomize on PYTHONPATH installs the finder), the port's
    CLI creates with --shards 2 --shard-workers {workers} on the CPU, and
    the archive extracts byte-equal through the port."""
    files = make_collection(tmp_path, random.Random(21), n_samples=2, contig_lens=(20000,))
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCK_REFERENCE)
    out = str(tmp_path / "sharded.agc")
    code = (
        "import sys\n"
        "import agc_tpu_torch\n"
        "from agc_tpu_torch.cli.main import main\n"
        f"assert main(['create', '--device', 'cpu', '--shards', '2', '--shard-workers', "
        f"{workers!r}, '-s', '3000', '-o', {out!r}, *{[p for _, p in files]!r}]) == 0\n"
        f"with agc_tpu_torch.AGCFile({out!r}) as agc:\n"
        "    print(agc.GetCtgSeq('s1', 'c1'))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('agc_tpu', 'jax')]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(site), REPO])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().encode() == _fasta_body(files[2][1], "c1")


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: no jax, no agc_tpu module and no
    bench helper may be imported by it directly."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    top = {n.split(".")[0] for n in names}
    assert "agc_tpu_torch" in top
    assert not top & {"agc_tpu", "bench", "jax", "jaxlib"}, sorted(names)


def test_cli_create_then_host_queries(tmp_path, device_match_off, capsys):
    """The port's own CLI: create through the port, then a query."""
    from agc_tpu_torch.cli.main import main

    files = make_collection(tmp_path, random.Random(9), n_samples=1,
                            contig_lens=(40000,))
    out = str(tmp_path / "cli.agc")
    assert main(["create", "--device", "cpu", "-s", "3000", "-o", out,
                 *[p for _, p in files]]) == 0
    ref = str(tmp_path / "tpu.agc")
    tpu_create(ref, [p for _, p in files], TpuParams(segment_size=3000))
    assert_same_archive(out, ref)
    capsys.readouterr()
    assert main(["getctg", out, "c1@s0"]) == 0
    got = "".join(capsys.readouterr().out.split("\n")[1:]).encode()
    assert got == _fasta_body(files[1][1], "c1")
    # --shards 2 runs the port's sharded create (thread workers); its
    # archive is agc_tpu's sharded create's
    from agc_tpu.parallel.distributed import create_archive_sharded as tpu_sharded

    sharded, tpu_sh = str(tmp_path / "sharded.agc"), str(tmp_path / "tpu_sh.agc")
    assert main(["create", "--device", "cpu", "--shards", "2", "-s", "3000", "-o", sharded,
                 *[p for _, p in files]]) == 0
    tpu_sharded(tpu_sh, [p for _, p in files], TpuParams(segment_size=3000), n_shards=2)
    assert_same_archive(sharded, tpu_sh)


def test_cuda_device_without_cuda_raises(tmp_path):
    import torch

    from agc_tpu_torch.core.compressor import Compressor

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    files = make_collection(tmp_path, random.Random(1), n_samples=0,
                            contig_lens=(5000,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Compressor(str(tmp_path / "x.agc"), reference_file=files[0][1])


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    import torch

    from agc_tpu_torch.utils.profiling import device_trace

    with device_trace("off"):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("AGC_TPU_PROFILE_DIR", str(tmp_path))
    with device_trace("create"):
        torch.ones(4).sum()
    assert (tmp_path / "create.json").stat().st_size > 0
