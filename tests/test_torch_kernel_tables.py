"""``chip_smoke.py``'s tables of the cluster kernels against the CUDA
sources, on the CPU (no card, no ``nvcc``).

Every ``__cluster_dims__(N, 1, 1)`` kernel of ``ray_tpu_torch/ops/csrc``
has an ``extern "C" int ray_*_max_clusters`` entry point that asks the card
how many of its clusters fit (``cudaOccupancyMaxActiveClusters``), and
``chip_smoke.py`` names each such entry in ``CLUSTER_FIT`` (with N), each
variant that runs a cluster kernel in ``CLUSTER_VARIANTS``, and their count
in ``CLUSTER_INSTANCES``; the generic instances that each source's
``launch_generic_d`` picks from are counted in ``GENERIC_INSTANCES``. On
the card a missing entry or a count that drifted shows only as a failed
phase; here the sources are read as text and the tables held against
them.
"""

import re
from pathlib import Path

import pytest

import chip_smoke

CSRC = Path(__file__).resolve().parents[1] / "ray_tpu_torch" / "ops" / "csrc"
SOURCES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# A cluster kernel: its cluster size, then its name at the start of a line.
KERNEL = re.compile(r"__cluster_dims__\((\d+), 1, 1\)[^\n]*\n(\w+)\(")
# A generic instance in launch_generic_d: its element type, the columns of
# its chunk and whether it is the chunked kernel (the backward sources,
# which have no one-chunk instance, name no flag).
GENERIC = re.compile(
    r"launch_generic<(\w+), ([\w *]+)(?:, (true|false))?>\(")
# A max-clusters entry: its name, the kernel it asks about and the size.
ENTRY = re.compile(r'extern "C" int (ray_\w+_max_clusters)\(int\* clusters\)'
                   r"\s*\{\s*return flash::max_clusters\(\s*(?:\w+::)*(\w+),"
                   r"\s*(\d+),")


def _read(name: str):
    """({kernel: CTAs a cluster}, [(entry, kernel, CTAs)]) of one source."""
    text = (CSRC / f"{name}.cu").read_text()
    kernels = {}
    for n, kernel in KERNEL.findall(text):
        assert kernel not in kernels, f"{name}.cu: {kernel} twice"
        kernels[kernel] = int(n)
    entries = [(e, k, int(n)) for e, k, n in ENTRY.findall(text)]
    return kernels, entries


def _all():
    """{entry: (source, kernel, CTAs)} and the cluster kernels' count over
    the three sources."""
    entries, count = {}, 0
    for name in SOURCES:
        kernels, found = _read(name)
        count += len(kernels)
        for entry, kernel, n in found:
            assert entry not in entries, f"{entry} twice"
            entries[entry] = (name, kernel, n)
    return entries, count


@pytest.mark.parametrize("name", SOURCES)
def test_every_cluster_kernel_has_one_max_clusters_entry(name):
    """Each cluster kernel of the source is named by exactly one
    ``ray_*_max_clusters`` entry of the same source, at its own cluster
    size, and each entry names a cluster kernel of that source."""
    kernels, entries = _read(name)
    assert kernels, f"{name}.cu has no cluster kernel"
    for kernel, n in kernels.items():
        named = [(e, m) for e, k, m in entries if k == kernel]
        assert len(named) == 1, f"{kernel}: entries {named}"
        assert named[0][1] == n, f"{kernel}: {n} CTAs, entry says {named}"
    for entry, kernel, _ in entries:
        assert kernel in kernels, f"{entry} names {kernel}, no cluster kernel"


def test_cluster_fit_names_every_entry_with_its_size():
    """``CLUSTER_FIT`` names exactly the sources' max-clusters entries, each
    under the library that defines it and with its kernel's cluster
    size."""
    entries, _ = _all()
    fit = {fn: (lib, n) for lib, fn, n in chip_smoke.CLUSTER_FIT.values()}
    assert len(fit) == len(chip_smoke.CLUSTER_FIT), "an entry named twice"
    assert fit == {e: (lib, n) for e, (lib, _, n) in entries.items()}


def test_cluster_fit_keys_are_the_cluster_variants():
    """``CLUSTER_FIT``'s keys (``kernel.variant``) are the variants that
    ``CLUSTER_VARIANTS`` runs on cluster kernels, and each key's library is
    its kernel."""
    variants = {f"{k}.{v}" for k, vs in chip_smoke.CLUSTER_VARIANTS.items()
                for v in vs}
    assert set(chip_smoke.CLUSTER_FIT) == variants
    for key, (lib, _, _) in chip_smoke.CLUSTER_FIT.items():
        assert key.split(".")[0] == lib, key


def test_cluster_instances_counts_the_cluster_kernels():
    """``CLUSTER_INSTANCES`` (the ptxas report's count that the card run
    checks) is the number of ``__cluster_dims__`` kernels."""
    _, count = _all()
    assert chip_smoke.CLUSTER_INSTANCES == count


def _generic_instances(name: str) -> set:
    """The distinct ``launch_generic<T, DC[, chunked]>`` instantiations
    in ``launch_generic_d`` of one source."""
    text = (CSRC / f"{name}.cu").read_text()
    start = text.index("int launch_generic_d(")
    return set(GENERIC.findall(text[start:text.index("\n}\n", start)]))


def test_generic_instances_counts_launch_generic_d():
    """``GENERIC_INSTANCES`` (the ptxas report's count of generic kernels,
    which the card run checks) is the number of one-chunk and chunked
    generic instances that the three sources' ``launch_generic_d``
    launch."""
    counts = {name: sorted(_generic_instances(name)) for name in SOURCES}
    assert all(counts.values()), counts
    assert sum(map(len, counts.values())) == \
        chip_smoke.GENERIC_INSTANCES, counts


@pytest.mark.parametrize("kernel, variant, kind", [
    ("flash_fwd", "f32_d384", "cluster"),
    ("flash_fwd", "bf16_d384", "cluster"),
    ("flash_bwd_dkv", "f32_d384", "cluster"),
    ("flash_bwd_dkv", "bf16_d384", "cluster"),
    ("flash_bwd_dq", "f32_d384", "cluster"),
    ("flash_bwd_dq", "bf16_d384", "cluster")])
def test_kernel_kind_at_d384(kernel, variant, kind):
    """At D384 all three kernels run cluster kernels in f32 and in bf16
    (the bf16 dQ's 3-CTA cluster last): the kind under which the parity
    runs count their launches."""
    assert chip_smoke.kernel_kind(kernel, variant) == kind


@pytest.mark.parametrize("kernel, variant, kind", [
    ("flash_fwd", "f32_d256", "cluster"),
    ("flash_bwd_dkv", "f32_d256", "cluster"),
    ("flash_bwd_dq", "f32_d256", "cluster"),
    ("flash_fwd", "bf16_d256", "wgmma"),
    ("flash_bwd_dkv", "bf16_d256", "wgmma"),
    ("flash_bwd_dq", "bf16_d256", "wgmma")])
def test_kernel_kind_at_d256(kernel, variant, kind):
    """At D256 f32 runs the 2-CTA cluster kernels of all three (the
    forward and dQ last) and bf16 the wgmma kernels of all three: every
    instance at D256 is a wgmma or cluster kernel, and these are the kinds
    under which the parity runs count their launches."""
    assert chip_smoke.kernel_kind(kernel, variant) == kind


@pytest.mark.parametrize("kernel, variant, kind", [
    ("flash_fwd", "f32_d128", "generic"),
    ("flash_bwd_dkv", "f32_d128", "cluster"),
    ("flash_bwd_dq", "f32_d128", "cluster")])
def test_kernel_kind_at_d128(kernel, variant, kind):
    """At f32 D128 the dK/dV and dQ run cluster kernels of 1 CTA and the
    forward its generic instance: the kinds under which the f32 D128
    parity run counts its launches."""
    assert chip_smoke.kernel_kind(kernel, variant) == kind
