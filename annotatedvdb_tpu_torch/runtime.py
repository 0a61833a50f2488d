"""Device resolution for every port entry point.

Counterpart of ``annotatedvdb_tpu/utils/runtime.py::pin_platform`` and
``utils/retry.py::device_put``.  The JAX package probes the accelerator
and falls back to the CPU when the probe fails; the port does not fall
back.  Entry points run on ``cuda:0`` unless the caller asks for the CPU,
and a missing card is an error, so a run that was meant for the card can
never finish quietly on the host.
"""

from __future__ import annotations

import numpy as np
import torch

#: the ``--platform`` choices of the port's CLIs (the reference's are
#: ``auto``/``cpu``)
PLATFORMS = ("cuda", "cpu")

#: Registry of every environment variable the port reads (name -> one-line
#: doc), the counterpart of ``annotatedvdb_tpu/config.py::ENV_VARS`` and
#: the list ``python -m annotatedvdb_tpu_torch.analysis`` judges reads
#: against (AVDB401 an undeclared read, AVDB402 an entry README does not
#: document, AVDB403 an entry nothing reads).  It holds the reference's
#: entries that the port reads, with the reference's docs, and the
#: port's own ``AVDBC_*`` knobs.  Left out, because the port never reads
#: them: the reference's benchmark knobs (``AVDB_BENCH_E2E_RUNS``,
#: ``AVDB_BENCH_EXPORT_ROWS``, ``AVDB_BENCH_RETRY_REASON``,
#: ``AVDB_BENCH_ROWS``, ``AVDB_BENCH_VEP_RUNS``), its test gates
#: (``AVDB_CRASH_TEST``, ``AVDB_SCALE_TEST``), its JAX platform pin
#: (``AVDB_JAX_PLATFORM``, ``AVDB_JAX_PLATFORM_SOURCE``), its
#: ``jax.profiler`` trace (``AVDB_PROFILE``; the port's is ``load-vcf
#: --profile``) and its TPU probe (``AVDB_TPU_MARKER``,
#: ``AVDB_TPU_MARKER_TTL_S``, ``AVDB_TPU_PROBE_TIMEOUT_S``).
ENV_VARS: dict = {
    # load pipeline
    "AVDB_PIPELINE": "overlapped (default) | serial — staged executor vs "
                     "single-thread double-buffered loop",
    "AVDB_ASYNC_STORE": "0 folds the store writer back into the process "
                        "thread (default 1: async writer stage)",
    "AVDB_INGEST_ENGINE": "auto (default) | native | python — VCF tokenizer "
                          "selection (python captures reject content)",
    "AVDB_INGEST_CHUNK_ROWS": "rows per ingest chunk (default: the "
                              "loader's batch_size; a malformed value "
                              "fails the entry point)",
    "AVDB_INGEST_PREFETCH_DEPTH": "chunks the ingest scanner may run "
                                  "ahead of the pipeline (default 2; "
                                  "bounds staging memory to O(depth) "
                                  "chunks)",
    "AVDB_INGEST_SHUFFLE_SEED": "arms shuffled chunk scheduling with this "
                                "seed (unset = strict source order; the "
                                "resequencer keeps the stored bytes "
                                "identical either way)",
    "AVDB_NATIVE_VEP": "0 disables the native VEP JSON transform",
    "AVDB_NATIVE_CADD": "0 disables the native CADD table scanner",
    "AVDB_PACK_TRANSPORT": "0 disables nibble-packed allele upload and "
                           "packed output transport",
    "AVDB_LOAD_GC": "0 keeps the collector enabled during bulk loads "
                    "(default: gc paused, one collect per load)",
    # device mesh (parallel/mesh.py is the single authority)
    "AVDB_MESH_SHAPE": "device count of the global 1-D mesh (unset = all "
                       "visible devices; a malformed value fails the "
                       "entry point; also recorded as the manifest's "
                       "advisory mesh_placement block at save time)",
    "AVDB_SERVE_MESH": "serve-side mesh execution: auto (default — "
                       "engages with >1 device on a non-CPU backend) | "
                       "1 (force, e.g. the tier-1 virtual-CPU mesh "
                       "tests) | 0 (disable)",
    "AVDB_MESH_BULK_MIN": "smallest bulk-lookup batch that pays a mesh "
                          "dispatch (default 64; 0 sends every batch)",
    # multi-host
    "AVDB_COORDINATOR": "host:port of the jax.distributed coordinator",
    "AVDB_NUM_PROCESSES": "world size for multi-host init",
    "AVDB_PROCESS_ID": "this process's rank for multi-host init",
    # store / robustness
    "AVDB_FSYNC": "1 extends durability to power loss (fsync segment data "
                  "and directories, not just manifest renames)",
    "AVDB_VERIFY": "load-time integrity level: size (default) | deep "
                   "(full checksums) | off",
    "AVDB_DEVICE_LOOKUP": "1 keeps membership-probe segments resident in "
                          "HBM (device lookup cache)",
    "AVDB_FAULT": "<point>:<nth|prob:<p>>[:<action>[:<ms>]] deterministic "
                  "fault injection (see utils/faults.py; unknown points "
                  "fail the arm)",
    "AVDB_FAULT_SEED": "integer seed for the prob:<p> fault-arming coin "
                       "(default 0xA5DB) — chaos runs replay exactly",
    "AVDB_STORE_SPILL_BYTES": "segment containers at/above this size load "
                              "as copy-on-write memmaps (out-of-core tier; "
                              "512m / 2g suffixes; unset/0 = materialize "
                              "everything)",
    "AVDB_COMPACT_CHUNK_ROWS": "rows per streamed merge chunk in doctor "
                               "compact (default 262144) — the unit of "
                               "peak row-payload memory during a pass",
    "AVDB_COMPACT_MIN_SEGMENTS": "smallest on-disk segment-file count that "
                                 "makes a chromosome group eligible for "
                                 "doctor compact (default 2)",
    "AVDB_MEMTABLE_BYTES": "approximate memtable size at which the live "
                           "write path flushes to store segments "
                           "(default 64m; 512m / 2g suffixes; 0 disables "
                           "the size trigger)",
    "AVDB_MEMTABLE_FLUSH_S": "oldest-unflushed-upsert age in seconds at "
                             "which the memtable flushes regardless of "
                             "size (default 30; 0 disables the age "
                             "trigger)",
    "AVDB_MAINTAIN": "1 arms the autonomous maintenance daemon in the "
                     "serve fleet supervisor (watermark-driven background "
                     "compaction; the --maintain flag is the CLI "
                     "spelling)",
    "AVDB_MAINTAIN_SEGMENTS_HIGH": "per-group segment-file count at which "
                                   "the maintenance daemon engages a "
                                   "compaction pass (default 8)",
    "AVDB_MAINTAIN_SEGMENTS_LOW": "hysteresis exit: the daemon disengages "
                                  "once every group is at/below this many "
                                  "segment files (default 2; clamped "
                                  "below the high watermark)",
    "AVDB_MAINTAIN_TICK_S": "maintenance daemon poll cadence in seconds, "
                            "jittered +/-25% (default 2)",
    "AVDB_MAINTAIN_COOLDOWN_S": "base cool-down after a paused/preempted/"
                                "failed maintenance pass, doubling per "
                                "consecutive setback up to 60s "
                                "(default 5)",
    "AVDB_STORE_DISK_RESERVE_BYTES": "free-disk reserve under the store "
                                     "below which upserts answer 507 "
                                     "Insufficient Storage on both front "
                                     "ends (512m / 2g suffixes; unset/0 "
                                     "disables) — reads, flushes of "
                                     "acknowledged rows, and compaction "
                                     "keep running",
    # query & serving (serve/)
    "AVDB_SERVE_BATCH_MAX": "max point queries coalesced into one device "
                            "microbatch (default 256)",
    "AVDB_SERVE_BATCH_WAIT_MS": "batcher drain deadline in ms: how long the "
                                "first query of a batch waits for company "
                                "(default 2)",
    "AVDB_SERVE_MAX_QUEUE": "admission bound: pending queries beyond this "
                            "are rejected with HTTP 429 (default 1024)",
    "AVDB_SERVE_REGION_CACHE": "LRU capacity of the rendered hot-region "
                               "cache, keyed by store generation "
                               "(default 64; 0 disables)",
    "AVDB_SERVE_REGIONS_MAX": "max query intervals per POST /regions batch "
                              "(default 4096; over-cap batches are 400)",
    "AVDB_SERVE_REGIONS_DEVICE_MIN": "min intervals per chromosome group "
                                     "before the batched BITS kernel "
                                     "engages (default 32; smaller groups "
                                     "take the byte-identical host path, "
                                     "0 sends every group to the device)",
    "AVDB_SERVE_STATS_MAX": "max query intervals per POST /stats/region "
                            "analytics batch (default 4096; over-cap "
                            "batches are 400)",
    "AVDB_SERVE_STATS_DEVICE_MIN": "min intervals per chromosome group "
                                   "before the fused stats kernel engages "
                                   "(default 16; smaller panels take the "
                                   "byte-identical host twin, 0 sends "
                                   "every group to the device)",
    "AVDB_SERVE_WORKERS": "serve fleet size: N>1 runs N worker processes "
                          "sharing the port and one readonly store "
                          "generation (default 1)",
    "AVDB_SERVE_HBM_BUDGET": "byte budget for HBM-resident probe segment "
                             "caches, e.g. 512m / 2g (unset = unmanaged: "
                             "the store's own ski-rental rule)",
    "AVDB_SERVE_SNAPSHOT_TTL_MS": "coalesced manifest freshness window: "
                                  "one stat per window across all request "
                                  "threads (default 250)",
    "AVDB_SERVE_CLIENT_RATE": "weighted per-client admission: requests/sec "
                              "per weight unit, rejected 429 beyond the "
                              "bucket (default 0 = disabled)",
    "AVDB_SERVE_STREAM_THRESHOLD": "region row count above which responses "
                                   "stream chunked instead of buffering "
                                   "the body (default 2048)",
    "AVDB_SERVE_DEFAULT_DEADLINE_MS": "default per-request deadline budget "
                                      "in ms (X-Deadline-Ms overrides; "
                                      "0 = requests carry no deadline)",
    "AVDB_SERVE_BROWNOUT_P99_MS": "brownout ladder latency target: when "
                                  ">~5% of recent requests exceed it the "
                                  "ladder escalates (default 250; 0 "
                                  "disables the latency trigger)",
    "AVDB_SERVE_WEDGE_TIMEOUT_S": "fleet watchdog: SIGKILL+respawn a live "
                                  "worker whose event-loop heartbeat is "
                                  "staler than this (default 10; 0 "
                                  "disables)",
    "AVDB_SERVE_CHAOS": "1 enables the POST /_chaos runtime fault-arming "
                        "route on the aio front end (chaos harness only; "
                        "never set in production)",
    "AVDB_SERVE_UPSERTS": "1 enables the live write path: POST "
                          "/variants/upsert with a per-worker WAL "
                          "(replayed on worker start) and memtable "
                          "flushes to store segments",
    # replication (store/replication.py; serve --follow / doctor promote)
    "AVDB_REPL_MAX_LAG_S": "declared follower staleness bound in seconds: "
                           "past it /readyz answers 503 and the "
                           "replication_lag SLO burns (default 5; 0 "
                           "disables both planes together)",
    "AVDB_REPL_POLL_S": "follower tail poll interval in seconds "
                        "(default 0.5; clamped to >= 0.02)",
    "AVDB_REPL_CHUNK_BYTES": "snapshot/WAL ship transfer chunk size "
                             "(default 4m; 512k / 8m suffixes; clamped "
                             "to >= 4k)",
    "AVDB_REPL_TIMEOUT_S": "per-request HTTP timeout for ship fetches "
                           "from the leader (default 10; clamped to "
                           ">= 0.1)",
    "AVDB_LOCK_TRACE": "1 arms the lock-order/deadlock detector: serve-"
                       "stack locks record per-thread acquisition order "
                       "(analysis/lockorder), cycles are potential "
                       "deadlocks, held time exports as "
                       "avdb_lock_held_seconds",
    "AVDB_IO_TRACE": "1 arms the crash-consistency sanitizer: store-path "
                     "open/write/fsync/rename/unlink route through "
                     "recording wrappers (utils/io) feeding a happens-"
                     "before recorder (analysis/iotrace) that flags "
                     "rename-before-fsync, unlink of a manifest-"
                     "referenced file, and missing directory fsync "
                     "after a manifest replace under AVDB_FSYNC=1",
    "AVDB_TRACE_SAMPLE": "fraction of requests recording per-stage span "
                         "breakdowns into the span ring + "
                         "avdb_stage_seconds (default 1.0; 0 disarms "
                         "recording — trace ids still mint and echo)",
    "AVDB_TRACE_SLOW_MS": "slow-request log threshold in ms: any request "
                          "over it logs its full span breakdown (default "
                          "0 = off)",
    "AVDB_FLIGHT_EVENTS": "crash flight-recorder ring slots per worker "
                          "(last-N request summaries + lifecycle events "
                          "in an mmap'd file that survives SIGKILL; "
                          "default 512, 0 disables)",
    "AVDB_OBS_TICK_S": "seconds between metrics time-series snapshots in "
                       "the health plane's history ring (default 1.0; 0 "
                       "disables the ring AND the SLO alert plane riding "
                       "it; malformed values fail startup)",
    "AVDB_OBS_HISTORY_S": "time-series history retention per worker in "
                          "seconds (default 300; 0 disables; the ring "
                          "persists to <store>/history/ for supervisor "
                          "harvest and doctor slo)",
    "AVDB_SLO_FAST_S": "fast SLO burn-rate window in seconds (default "
                       "60): proves a breach is happening NOW; both "
                       "windows must burn past AVDB_SLO_BURN to alert",
    "AVDB_SLO_SLOW_S": "slow (confirming) SLO burn-rate window in "
                       "seconds (default 300; must be >= the fast "
                       "window): proves a breach is sustained",
    "AVDB_SLO_BURN": "burn-rate threshold both SLO windows must exceed "
                     "for an alert to breach (default 2.0 = spending "
                     "error budget twice as fast as the objective "
                     "allows)",
    "AVDB_SLO_AVAIL_TARGET": "availability SLO objective as a fraction "
                             "in (0, 1) (default 0.999; the error "
                             "budget is 1 - target)",
    "AVDB_SLO_LOAD_FLOOR": "load-pipeline variants/sec floor SLO "
                           "(default 0 = declared but dormant; alerts "
                           "when the windowed avdb_rows_total rate "
                           "drops below it)",
    # ML corpus export (export/)
    "AVDB_EXPORT_BATCH_ROWS": "rows per fixed-shape export batch (default "
                              "4096): every batch of a corpus shares this "
                              "one shape — one traced pack kernel, "
                              "explicit validity mask at the ragged tail",
    "AVDB_EXPORT_SHUFFLE_SEED": "corpus shuffle seed (default 0): same "
                                "seed => byte-identical corpus; the "
                                "export CLI's --seed overrides, --ordered "
                                "disables the shuffle",
    "AVDB_EXPORT_PART_BYTES": "target committed corpus-part size (default "
                              "8m; k/m/g suffixes): parts hold a "
                              "deterministic whole number of batches",
    # the port's own knobs
    "AVDBC_VIRTUAL_DEVICES": "N shards of the one device --platform "
                             "resolves make the loaders' and the "
                             "server's device pool (parallel/mesh.py; "
                             "refused where torch sees several cards)",
}


def resolve_device(platform: str | torch.device | None = None) -> torch.device:
    """``"cuda"`` (the default) -> ``cuda:0``; ``"cpu"`` -> the host.

    Raises RuntimeError when CUDA is asked for and no device is present."""
    if isinstance(platform, torch.device):
        platform = platform.type if platform.index is None else str(platform)
    name = (platform or "cuda").strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "cuda:0"):
        raise ValueError(f"unknown platform {platform!r}: expected one of {PLATFORMS}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass platform 'cpu' (--platform cpu) "
            "to run on the host"
        )
    return torch.device("cuda", 0)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload one host array.  On CUDA the bytes go through a pinned
    staging buffer and a ``non_blocking`` copy on the current stream (the
    caching host allocator keeps the buffer alive until the copy is done);
    on the CPU the tensor shares the array's memory."""
    x = np.ascontiguousarray(x)
    if device.type != "cuda":
        return torch.from_numpy(x)
    staging = torch.empty(x.shape, dtype=torch.from_numpy(x[:0]).dtype,
                          pin_memory=True)
    staging.numpy()[...] = x
    return staging.to(device, non_blocking=True)


def validate_max_workers(max_workers: str) -> None:
    """``--maxWorkers`` must be ``auto``, ``off`` or a count >= 1 (the
    reference's ``RuntimeConfig.validate``); raises ValueError."""
    if max_workers in ("auto", "off"):
        return
    try:
        if int(max_workers) < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"maxWorkers must be auto, off, or a count >= 1, "
            f"not {max_workers!r}"
        ) from None


def apply_runtime(platform: str | None, max_workers: str = "auto",
                  multihost: bool = True):
    """The counterpart of the reference's ``RuntimeConfig.apply``: resolve
    the platform (a missing card raises), join the multi-host world when
    the environment configures one (unless ``multihost`` is False), and
    return the loaders' mesh — this process's device pool, bounded by
    ``AVDB_MESH_SHAPE`` and clamped by ``--maxWorkers`` — or None for a
    single shard."""
    from annotatedvdb_tpu_torch.parallel.mesh import device_pool, global_mesh

    validate_max_workers(max_workers)
    resolve_device(platform)
    if multihost:
        from annotatedvdb_tpu_torch.parallel.multihost import init_multihost

        init_multihost(platform=platform)
    if max_workers == "off":
        return None
    # loads stay share-nothing per process: the mesh is this process's
    # shards, never the world's
    return global_mesh(
        limit=None if max_workers == "auto" else int(max_workers),
        devices=device_pool(platform),
    )
