"""Table-I workload matrix: 23 scenarios across 6 applications.

Each workload carries:
* ``phases``      — the structural I/O behavior (drives simulator + oracle),
* ``source_code`` — a C-like I/O kernel snippet (static-extractor input),
* ``job_script``  — the launch script (static-extractor input),
* ``n_nodes``     — evaluation scale.

FIO Test-E expands to three scenarios (read ratios 10/50/90%), giving
4 (IOR) + 3+3 (FIO) + 3 (HACC) + 3 (MAD) + 4 (MDTEST) + 3 (S3D) = 23 —
matching the paper's accuracy denominators (21/23 = 91.30%).

A copy of ``repro.core.workloads``; the port imports nothing of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.simulator import Phase


@dataclass
class Workload:
    """One suite entry: app id, phase list and the static artifacts."""
    app: str
    test_id: str
    description: str
    phases: List[Phase]
    source_code: str
    job_script: str
    n_nodes: int = 32

    @property
    def name(self) -> str:
        """Canonical "app-test_id" workload identifier."""
        return f"{self.app}-{self.test_id}"


# ---------------------------------------------------------------------------
# source-code fixtures (C-like I/O kernels)
# ---------------------------------------------------------------------------
_IOR_FPP_SRC = r"""
/* IOR core write loop: file-per-process mode (-F). */
void write_phase(int rank, size_t block, size_t xfer) {
  char fname[256];
  sprintf(fname, "%s.%08d", o.testFileName, rank);    /* rank-indexed file */
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  for (size_t off = 0; off < block; off += xfer)
    pwrite(fd, buf, xfer, off);                        /* sequential */
  close(fd);
}
"""

_IOR_SHARED_SRC = r"""
/* IOR shared-file read: all ranks read one file with MPI-IO collectives. */
void read_phase(MPI_File fh, size_t block, size_t xfer, int rank, int np) {
  MPI_Offset off = (MPI_Offset)rank * xfer;            /* strided N-1 */
  for (size_t i = 0; i < block / xfer; i++) {
    MPI_File_read_at_all(fh, off, buf, xfer, MPI_BYTE, &st); /* collective */
    off += (MPI_Offset)np * xfer;
  }
}
"""

_IOR_SMALL_SRC = r"""
/* IOR small segmented R/W: tiny transfers, many segments, fsync storms. */
void segmented_rw(int fd, int segs, size_t xfer) {
  for (int s = 0; s < segs; s++) {
    pwrite(fd, buf, xfer, s * xfer);                   /* 4 KiB writes */
    fsync(fd);                                         /* metadata pressure */
    pread(fd, buf, xfer, s * xfer);
    stat(path, &sb);
  }
}
"""

_IOR_MIXED_SRC = r"""
/* IOR mixed phase: checkpoint then cross-rank validation read. */
void mixed(int rank, int np) {
  char fname[256];
  sprintf(fname, "ckpt.%06d", rank);                   /* rank-indexed */
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  for (int i = 0; i < nseg; i++) pwrite(fd, buf, XFER, i * XFER);
  close(fd);
  MPI_Barrier(MPI_COMM_WORLD);
  sprintf(fname, "ckpt.%06d", (rank + 1) % np);        /* neighbor's file! */
  fd = open(fname, O_RDONLY);
  for (int i = 0; i < nseg; i++) pread(fd, buf, XFER, i * XFER);
}
"""

_FIO_CKPT_SRC = r"""
; fio job: per-process checkpoint simulation
[global]
ioengine=psync
direct=1
rw=write              ; sequential write
bs=4m
[ckpt]
filename_format=ckpt.$jobnum    ; one file per job/process
numjobs=${NJOBS}
size=4g
"""

_FIO_META_SRC = r"""
; fio job: AI-style massive small files, random access
[global]
ioengine=psync
rw=randread
bs=4k
nrfiles=100000        ; massive small file population
filesize=16k
openfiles=512
[smallfiles]
numjobs=${NJOBS}
file_service_type=random
"""

_FIO_HYBRID_SRC = r"""
; fio job: shared-file write burst + 30% random reads
[global]
ioengine=libaio
filename=shared.dat    ; single shared file (N-1)
[writers]
rw=write
bs=1m
[readers]
rw=randread
bs=4k
; read fraction configured at 30%
"""

_FIO_SHARED_RW_SRC = r"""
; fio job: shared-file mixed random R/W, read ratio swept
[global]
ioengine=libaio
filename=shared.dat    ; single shared file (N-1)
rw=randrw
rwmixread=${READPCT}
bs=4k
iodepth=1
"""

_HACC_WRITE_SRC = r"""
/* HACC-IO checkpoint: all ranks write one shared restart file (N-1). */
void hacc_checkpoint(MPI_File fh, particles_t *p, int rank) {
  MPI_Offset off = (MPI_Offset)rank * p->nbytes;       /* contiguous slabs */
  MPI_File_write_at_all(fh, off, p->buf, p->nbytes,    /* collective write */
                        MPI_BYTE, &st);
  MPI_File_sync(fh);
}
"""

_HACC_READ_SRC = r"""
/* HACC-IO restart: global analysis read of the shared checkpoint. */
void hacc_restart(MPI_File fh, particles_t *p, int rank, int np) {
  for (int r = 0; r < np; r++) {                       /* every rank reads */
    MPI_Offset off = (MPI_Offset)r * p->nbytes;        /* ...all slabs */
    MPI_File_read_at(fh, off, p->buf, p->nbytes, MPI_BYTE, &st);
  }
}
"""

_HACC_META_SRC = r"""
/* HACC-IO attribute exchange: many tiny metadata-ish records. */
void hacc_attrs(const char *dir, int rank) {
  char path[256];
  for (int i = 0; i < NATTR; i++) {
    sprintf(path, "%s/attr.%d.%d", dir, rank, i);
    int fd = open(path, O_CREAT | O_WRONLY, 0664);     /* small creates */
    write(fd, &attr[i], sizeof(attr_t));               /* 64-byte records */
    close(fd);
    stat(path, &sb);                                   /* latency sensitive */
  }
}
"""

_MAD_COLLECTIVE_SRC = r"""
/* MADbench2: out-of-core matrix writes, collective shared-file I/O. */
void mad_write(MPI_File fh, double *A, size_t n, int rank) {
  MPI_Offset off = (MPI_Offset)rank * n * sizeof(double);
  MPI_File_set_view(fh, off, MPI_DOUBLE, MPI_DOUBLE, "native", info);
  MPI_File_write_all(fh, A, n, MPI_DOUBLE, &st);       /* N-1 collective */
}
"""

_MAD_UNIQUE_SRC = r"""
/* MADbench2 unique-stream mode: one output stream per rank. */
void mad_write_unique(double *A, size_t n, int rank) {
  char fname[256];
  sprintf(fname, "gasdev/bin.%05d", rank);             /* rank-indexed */
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  write(fd, A, n * sizeof(double));                     /* large sequential */
  close(fd);
}
"""

_MAD_SMALL_SRC = r"""
/* MADbench2 S-phase: small interleaved data + metadata operations. */
void mad_small(const char *dir, int rank) {
  for (int i = 0; i < NITER; i++) {
    pwrite(fd, tile, TILE_BYTES, tile_off(i, rank));   /* 64 KiB tiles */
    pread(fd, tile, TILE_BYTES, tile_off(i + 1, rank));
    if (i % 8 == 0) { fstat(fd, &sb); utime(path, 0); } /* mixed meta */
  }
}
"""

_MDTEST_SRC = r"""
/* mdtest main loop: create/stat/remove in a directory tree. */
void mdtest_phase(const char *dir, int rank, int nfiles, int unique) {
  char path[512];
  for (int i = 0; i < nfiles; i++) {
    if (unique) sprintf(path, "%s/rank%04d/f.%d", dir, rank, i);
    else        sprintf(path, "%s/shared/f.%d.%d", dir, rank, i);
    int fd = creat(path, 0664);   close(fd);
    stat(path, &sb);
  }
  for (int i = 0; i < nfiles; i++) unlink(path_of(i));
}
"""

_S3D_WRITE_SRC = r"""
/* S3D restart dump: each rank writes its own field file, then a
   neighbor-exchange validation read. */
void s3d_checkpoint(field_t *f, int rank, int np) {
  char fname[256];
  sprintf(fname, "field.%06d.dat", rank);              /* file per process */
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  write(fd, f->data, f->nbytes);                        /* large sequential */
  close(fd);
  MPI_Barrier(MPI_COMM_WORLD);
  sprintf(fname, "field.%06d.dat", (rank + 1) % np);    /* halo check */
  fd = open(fname, O_RDONLY);
  pread(fd, halo, HALO_BYTES, 0);
  close(fd);
}
"""

_S3D_READ_SRC = r"""
/* S3D restart: every rank reads the full previous dump set. */
void s3d_restart(int rank, int np) {
  char fname[256];
  for (int r = 0; r < np; r++) {
    sprintf(fname, "field.%06d.dat", r);                /* global gather */
    int fd = open(fname, O_RDONLY);
    read(fd, f->data, f->nbytes);
    close(fd);
  }
}
"""

_S3D_SMALL_SRC = r"""
/* S3D thermo-table updates: tiny latency-critical records. */
void s3d_tables(int fd, int rank) {
  for (int i = 0; i < NTAB; i++) {
    pwrite(fd, &tab[i], 512, i * 512);                  /* 512 B writes */
    pread(fd, &tab[i], 512, i * 512);
    if ((i & 15) == 0) fstat(fd, &sb);
  }
}
"""


def _script(app: str, nodes: int, ppn: int, extra: str) -> str:
    return f"""#!/bin/bash
#SBATCH -N {nodes}
#SBATCH --ntasks-per-node={ppn}
#SBATCH -J {app}
module load {app.lower()}
srun -n {nodes * ppn} {extra}
"""


# ---------------------------------------------------------------------------
# the 23-scenario matrix
# ---------------------------------------------------------------------------
def build_workloads(n_nodes: int = 32) -> List[Workload]:
    """Construct the paper's full workload suite at ``n_nodes``."""
    W: List[Workload] = []
    gb = 1024.0

    # ---- IOR -------------------------------------------------------------
    W.append(Workload(
        "IOR", "A", "N-N write: independent file-per-process, sequential",
        [Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 4 * gb, req_kib=4096)],
        _IOR_FPP_SRC,
        _script("IOR", n_nodes, 8,
                "ior -a POSIX -F -w -b 4g -t 4m -o /bb/ior_fpp"),
        n_nodes))
    W.append(Workload(
        "IOR", "B", "N-1 read: shared file, collision-heavy",
        [Phase("bw", op="read", topology="N1", pattern="strided",
               total_mib=n_nodes * 2 * gb, req_kib=4096,
               written_by="other")],
        _IOR_SHARED_SRC,
        _script("IOR", n_nodes, 8,
                "ior -a MPIIO -r -c -b 2g -t 4m -o /bb/shared_file"),
        n_nodes))
    W.append(Workload(
        "IOR", "C", "Meta-heavy: small segmented R/W",
        [Phase("iops", op="mixed", read_ratio=0.5, pattern="seq",
               req_kib=4, n_ops=400_000, written_by="shared"),
         Phase("meta", n_ops=120_000, dir_pattern="shared",
               meta_mix={"create": 0.4, "stat": 0.5, "remove": 0.1})],
        _IOR_SMALL_SRC,
        _script("IOR", n_nodes, 8,
                "ior -a POSIX -w -r -b 64m -t 4k -s 128 -o /bb/segments -e"),
        n_nodes))
    W.append(Workload(
        "IOR", "D", "Mixed: segmented dynamic R/W (write then remote read)",
        [Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 2 * gb, req_kib=1024),
         Phase("bw", op="read", topology="NN", pattern="seq",
               total_mib=n_nodes * 2 * gb, req_kib=1024,
               written_by="other")],
        _IOR_MIXED_SRC,
        _script("IOR", n_nodes, 8,
                "ior -a POSIX -w -r -F -b 2g -t 1m -o /bb/ckpt -C"),
        n_nodes))

    # ---- FIO -------------------------------------------------------------
    W.append(Workload(
        "FIO", "A", "N-N write: checkpoint simulation",
        [Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 4 * gb, req_kib=4096)],
        _FIO_CKPT_SRC,
        _script("FIO", n_nodes, 4, "fio --section=ckpt ckpt.fio"),
        n_nodes))
    W.append(Workload(
        "FIO", "C", "AI/meta: massive small files, random access",
        [Phase("meta", n_ops=800_000, dir_pattern="shared",
               meta_mix={"create": 0.7, "stat": 0.3}),
         Phase("iops", op="read", pattern="random", req_kib=4,
               n_ops=600_000, written_by="other")],
        _FIO_META_SRC,
        _script("FIO", n_nodes, 4, "fio --section=smallfiles small.fio"),
        n_nodes))
    W.append(Workload(
        "FIO", "D", "Hybrid: N-1 write + random read (30%)",
        [Phase("bw", op="write", topology="N1", pattern="seq",
               total_mib=n_nodes * 1 * gb, req_kib=1024),
         Phase("iops", op="mixed", read_ratio=0.30, req_kib=4,
               n_ops=300_000, written_by="shared")],
        _FIO_HYBRID_SRC,
        _script("FIO", n_nodes, 4, "fio hybrid.fio"),
        n_nodes))
    for pct in (10, 50, 90):
        W.append(Workload(
            "FIO", f"E{pct}",
            f"Shared R/W: read ratio {pct}%",
            [Phase("iops", op="mixed", read_ratio=pct / 100.0, req_kib=4,
                   n_ops=400_000, written_by="shared")],
            _FIO_SHARED_RW_SRC.replace("${READPCT}", str(pct)),
            _script("FIO", n_nodes, 4,
                    f"fio --rwmixread={pct} sharedrw.fio"),
            n_nodes))

    # ---- HACC ------------------------------------------------------------
    W.append(Workload(
        "HACC", "A", "N-1 write: large-scale checkpointing",
        [Phase("bw", op="write", topology="N1", pattern="seq",
               total_mib=n_nodes * 3 * gb, req_kib=8192)],
        _HACC_WRITE_SRC,
        _script("HACC", n_nodes, 8, "hacc_io 64000000 /bb/restart.hacc"),
        n_nodes))
    W.append(Workload(
        "HACC", "B", "N-1 read: global analysis/restart",
        [Phase("bw", op="read", topology="N1", pattern="seq",
               total_mib=n_nodes * 3 * gb, req_kib=8192,
               written_by="other")],
        _HACC_READ_SRC,
        _script("HACC", n_nodes, 8,
                "hacc_io_read 64000000 /bb/restart.hacc"),
        n_nodes))
    W.append(Workload(
        "HACC", "C", "Latency: small metadata-op sensitivity",
        [Phase("meta", n_ops=200_000, dir_pattern="shared",
               meta_mix={"create": 0.45, "stat": 0.45, "remove": 0.10})],
        _HACC_META_SRC,
        _script("HACC", n_nodes, 8, "hacc_attrs /bb/attrs"),
        n_nodes))

    # ---- MADbench2 ---------------------------------------------------------
    W.append(Workload(
        "MAD", "A", "N-1 write: collective I/O coordination",
        [Phase("bw", op="write", topology="N1", pattern="strided",
               total_mib=n_nodes * 2 * gb, req_kib=2048)],
        _MAD_COLLECTIVE_SRC,
        _script("MADbench2", n_nodes, 4, "MADbench2 16384 8 8 W"),
        n_nodes))
    W.append(Workload(
        "MAD", "B", "N-N write: unique stream throughput",
        [Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 3 * gb, req_kib=4096)],
        _MAD_UNIQUE_SRC,
        _script("MADbench2", n_nodes, 4, "MADbench2 16384 8 8 W -unique"),
        n_nodes))
    W.append(Workload(
        "MAD", "C", "Small I/O: mixed data & metadata",
        [Phase("iops", op="mixed", read_ratio=0.5, req_kib=64,
               n_ops=250_000, written_by="other"),
         Phase("meta", n_ops=60_000, dir_pattern="shared",
               meta_mix={"stat": 0.7, "create": 0.3}, cross_rank=0.5)],
        _MAD_SMALL_SRC,
        _script("MADbench2", n_nodes, 4, "MADbench2 4096 8 8 S"),
        n_nodes))

    # ---- MDTEST ------------------------------------------------------------
    W.append(Workload(
        "MDTEST", "A", "Independent metadata: file-per-process (unique dir)",
        [Phase("meta", n_ops=1_000_000, dir_pattern="unique",
               meta_mix={"create": 0.5, "stat": 0.3, "remove": 0.2},
               cross_rank=1.0)],   # mdtest -N: stats hit the next rank's files
        _MDTEST_SRC,
        _script("mdtest", n_nodes, 8,
                "mdtest -n 4000 -u -N 1 -d /bb/md_unique"),
        n_nodes))
    W.append(Workload(
        "MDTEST", "B", "Shared metadata: N-1 directory contention",
        [Phase("meta", n_ops=1_000_000, dir_pattern="shared",
               meta_mix={"create": 0.5, "stat": 0.3, "remove": 0.2})],
        _MDTEST_SRC,
        _script("mdtest", n_nodes, 8, "mdtest -n 4000 -d /bb/md_shared"),
        n_nodes))
    W.append(Workload(
        "MDTEST", "C", "Deep tree: recursive namespace stress",
        [Phase("meta", n_ops=600_000, dir_pattern="deep",
               meta_mix={"create": 0.4, "stat": 0.4, "remove": 0.2})],
        _MDTEST_SRC,
        _script("mdtest", n_nodes, 8, "mdtest -n 500 -z 8 -b 4 -d /bb/tree"),
        n_nodes))
    W.append(Workload(
        "MDTEST", "D", "2-Phase: create then stat (cache test)",
        [Phase("meta", n_ops=500_000, dir_pattern="unique",
               meta_mix={"create": 1.0}),
         Phase("meta", n_ops=500_000, dir_pattern="unique",
               meta_mix={"stat": 1.0}, cross_rank=1.0)],
        _MDTEST_SRC,
        _script("mdtest", n_nodes, 8,
                "mdtest -n 2000 -u -C -T -N 1 -d /bb/2ph"),
        n_nodes))

    # ---- S3D ---------------------------------------------------------------
    W.append(Workload(
        "S3D", "A", "N-N write: checkpoint burst (+ halo validation read)",
        [Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 3 * gb, req_kib=4096),
         Phase("bw", op="read", topology="NN", pattern="seq",
               total_mib=n_nodes * 0.4 * gb, req_kib=1024,
               written_by="other")],
        _S3D_WRITE_SRC,
        _script("S3D", n_nodes, 8, "s3d_io.x 2025 checkpoint"),
        n_nodes))
    W.append(Workload(
        "S3D", "B", "Global read: restart pattern",
        [Phase("bw", op="read", topology="N1", pattern="seq",
               total_mib=n_nodes * 3 * gb, req_kib=4096,
               written_by="other")],
        _S3D_READ_SRC,
        _script("S3D", n_nodes, 8, "s3d_io.x 2025 restart"),
        n_nodes))
    W.append(Workload(
        "S3D", "C", "Small I/O: latency-sensitive table updates",
        [Phase("iops", op="mixed", read_ratio=0.5, req_kib=0.5,
               n_ops=200_000, written_by="shared"),
         Phase("meta", n_ops=40_000, dir_pattern="shared",
               meta_mix={"stat": 1.0})],
        _S3D_SMALL_SRC,
        _script("S3D", n_nodes, 8, "s3d_io.x 2025 tables"),
        n_nodes))

    assert len(W) == 23, len(W)
    return W


def workload_by_name(name: str, n_nodes: int = 32) -> Workload:
    """Look up one suite workload by its canonical name."""
    for w in build_workloads(n_nodes):
        if w.name == name:
            return w
    raise KeyError(name)


# ---------------------------------------------------------------------------
# adversarial corpus: kernels the regex engine misreads (AST engine wins)
# ---------------------------------------------------------------------------
_ADV_DEAD_COLLECTIVE_SRC = r"""
/* v2 checkpoint: file-per-process; the old shared-file path is compiled
   out but still present in the source. */
void ckpt_v2(int rank, size_t nblk) {
  char fname[256];
  int id = rank;                             /* local alias */
  sprintf(fname, "ckpt2.%07d", id);
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  if (0) {
    /* legacy shared-file path, disabled since v2 */
    MPI_File_write_at_all(gfh, (MPI_Offset)id * nblk, buf, nblk,
                          MPI_BYTE, &st);
  }
  for (size_t b = 0; b < nblk; b++)
    pwrite(fd, buf, BLK, b * BLK);
  close(fd);
}
"""

_ADV_WRAPPER_SRC = r"""
/* Streaming writer behind a thin wrapper; the verify read-back helper
   is referenced only from a disabled branch. */
static void put_block(int fd, const char *p, size_t nb, size_t off) {
  pwrite(fd, p, nb, off);
}
static void get_block(int fd, char *p, size_t nb, size_t off) {
  pread(fd, p, nb, off);
}
void stream_out(int rank, int nblk) {
  char fname[256];
  sprintf(fname, "stream.%05d", rank);
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  for (int b = 0; b < nblk; b++) {
    put_block(fd, buf, BLK, (size_t)b * BLK);
    if (0)
      get_block(fd, chk, BLK, (size_t)b * BLK);   /* paranoid verify */
  }
  close(fd);
}
"""

_ADV_SHARED_COMMENT_SRC = r"""
/* All ranks dump into the shared scratch tree. */
void scratch_dump(int rank, int nblk) {
  char fname[256];
  int me = rank;
  sprintf(fname, "scratch/%07d.blk", me);      /* per-rank file names */
  int fd = open(fname, O_CREAT | O_WRONLY, 0664);
  for (int b = 0; b < nblk; b++)
    pwrite(fd, buf, BLK, (size_t)b * BLK);
  close(fd);
}
"""

_ADV_GUARDED_META_SRC = r"""
/* Append-only logger: health-check metadata only every 4096 records. */
void rolling_log(int rank, int nrec) {
  char fname[256];
  sprintf(fname, "log.%05d", rank);
  int fd = open(fname, O_CREAT | O_WRONLY | O_APPEND, 0664);
  for (int i = 0; i < nrec; i++) {
    write(fd, rec, RECSZ);
    if (i % 4096 == 0)
      fstat(fd, &sb);
    if (i % 4096 == 0)
      utime(fname, 0);
  }
  close(fd);
}
"""

_ADV_COMM_SELF_SRC = r"""
/* MPI-IO used purely per-process: every rank opens its own file on
   MPI_COMM_SELF -- no file is ever shared. */
void private_dump(int rank, int nb) {
  char fname[256];
  MPI_File fh;
  int me = rank;
  sprintf(fname, "part.%06d.bin", me);
  MPI_File_open(MPI_COMM_SELF, fname, MPI_MODE_CREATE | MPI_MODE_WRONLY,
                MPI_INFO_NULL, &fh);
  MPI_File_write(fh, buf, nb, MPI_BYTE, &st);
  MPI_File_close(&fh);
}
"""

_ADV_HIDDEN_NEIGHBOR_SRC = r"""
/* Halo exchange via files: write own block, then read the wraparound
   neighbor's block (the neighbor index is computed, not inlined). */
void halo_exchange(int rank, int np, int nseg) {
  char fname[256];
  sprintf(fname, "halo.%06d", rank);
  int fd = open(fname, O_WRONLY);
  for (int i = 0; i < nseg; i++)
    pwrite(fd, buf, XFER, i * XFER);
  close(fd);
  MPI_Barrier(MPI_COMM_WORLD);
  int peer = rank + 1;
  if (peer == np)
    peer = 0;                                /* wraparound neighbor */
  sprintf(fname, "halo.%06d", peer);
  fd = open(fname, O_RDONLY);
  for (int i = 0; i < nseg; i++)
    pread(fd, buf, XFER, i * XFER);
  close(fd);
}
"""


def adversarial_workloads(n_nodes: int = 32) -> List[Workload]:
    """Kernels crafted so textual pattern-matching misclassifies them.

    Each case targets one regex blind spot — dead branches, wrapper
    indirection, comment words, unbraced sampling guards, communicator
    scope, computed neighbor indices — while the AST/dataflow engine
    recovers the true intent.  Evaluated statically (``use_runtime=
    False``) against the simulator oracle; not part of the 23-scenario
    paper matrix.
    """
    gb = 1024.0
    nn_write = [Phase("bw", op="write", topology="NN", pattern="seq",
                      total_mib=n_nodes * 4 * gb, req_kib=4096)]
    script = _script("ADV", n_nodes, 8, "adv_io /bb/adv")
    W = [
        Workload("ADV", "A", "Dead-branch collective: live path is N-N",
                 list(nn_write), _ADV_DEAD_COLLECTIVE_SRC, script, n_nodes),
        Workload("ADV", "B", "Wrapper write + dead verify read",
                 list(nn_write), _ADV_WRAPPER_SRC, script, n_nodes),
        Workload("ADV", "C", "Rank files under shared parent (comment bait)",
                 list(nn_write), _ADV_SHARED_COMMENT_SRC, script, n_nodes),
        Workload("ADV", "D", "Guarded metadata: unbraced modulo sampling",
                 list(nn_write), _ADV_GUARDED_META_SRC, script, n_nodes),
        Workload("ADV", "E", "MPI_COMM_SELF: per-process MPI-IO, not N-1",
                 list(nn_write), _ADV_COMM_SELF_SRC, script, n_nodes),
        Workload("ADV", "F", "Hidden wraparound-neighbor read-back",
                 [Phase("bw", op="write", topology="NN", pattern="seq",
                        total_mib=n_nodes * 2 * gb, req_kib=1024),
                  Phase("bw", op="read", topology="NN", pattern="seq",
                        total_mib=n_nodes * 2 * gb, req_kib=1024,
                        written_by="other")],
                 _ADV_HIDDEN_NEIGHBOR_SRC, script, n_nodes),
    ]
    return W


# ---------------------------------------------------------------------------
# heterogeneous-scope workload (layout-heterogeneity demo + tests)
# ---------------------------------------------------------------------------
_HETERO_SRC = _FIO_CKPT_SRC + _FIO_META_SRC


def heterogeneous_workload(n_nodes: int = 32) -> Workload:
    """A job whose directories want *different* layouts: an N-N checkpoint
    burst under ``/bb/ckpt`` (locality wins) interleaved with a massive
    shared small-file phase under ``/bb/shared`` (hashing wins).  No single
    ``LayoutMode`` serves both — the structural mismatch ``LayoutPolicy``
    exists to eliminate."""
    gb = 1024.0
    return Workload(
        "MIX", "A",
        "Heterogeneous: N-N checkpoint scope + shared small-file scope",
        [Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 4 * gb, req_kib=4096, scope="/bb/ckpt"),
         Phase("meta", n_ops=800_000, dir_pattern="shared",
               meta_mix={"create": 0.7, "stat": 0.3}, scope="/bb/shared"),
         Phase("iops", op="read", pattern="random", req_kib=4,
               n_ops=600_000, written_by="other", scope="/bb/shared"),
         Phase("bw", op="write", topology="NN", pattern="seq",
               total_mib=n_nodes * 4 * gb, req_kib=4096, scope="/bb/ckpt")],
        _HETERO_SRC,
        _script("MIX", n_nodes, 8,
                "mix_job --ckpt /bb/ckpt --data /bb/shared"),
        n_nodes)
