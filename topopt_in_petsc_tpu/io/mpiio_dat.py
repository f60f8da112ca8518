"""Reference-compatible binary field output (`output_00000.dat`).

Byte-for-byte the format MPIIO writes (MPIIO.cc:207-714) and
bin2vtu_v3.py consumes, so existing post-processing pipelines built for
the reference keep working against this framework's outputs:

  [info string + "\\n" + \\x01]                      chars
  [nDom][nPointsT/dom][nCellsT/dom][nPFields/dom][nCFields/dom][nodesPerElem]
                                                    u64 header (2 + 4*nDom)
  [pointFieldNames + \\x01][cellFieldNames + \\x01]  chars
  points:   3*f32 per point                          (per domain)
  conn:     nodesPerElement*u64 per cell
  offsets:  u64 per cell (cumulative)
  types:    u64 per cell (VTK_HEXAHEDRON = 12; the reference writes the
            DMDA code 1000 which bin2vtu maps to 12 — both decode)
  then per written "timestep":
  [iteration u64][each point field f32*nPoints][each cell field f32*nCells]

The reference distributes these writes over MPI-IO with per-rank offsets
(MPIIO.cc:380-714); here a single host streams the same bytes.
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence

import numpy as np

from topopt_in_petsc_tpu.io.vtu import hex_connectivity


class MPIIODat:
    """One shared output file accumulating per-iteration field dumps
    (the MPIIO class of the reference, main.cc:40)."""

    def __init__(
        self,
        path: str,
        grid,
        info: str = "TopOpt in JAX",
        point_field_names: str = "ux, uy, uz",
        cell_field_names: str = "x, xTilde, xPhys",
    ):
        self.path = path
        self.grid = grid
        self.n_pfields = len(point_field_names.split(","))
        self.n_cfields = len(cell_field_names.split(","))
        npoints = grid.nnode
        ncells = grid.nelem

        with open(path, "wb") as f:
            f.write(info.encode() + b"\n\x01")
            header = [1, npoints, ncells, self.n_pfields, self.n_cfields, 8]
            f.write(struct.pack(f"<{len(header)}Q", *header))
            # trailing \n: the decoder (bin2vtu_v3.py readInString, and
            # read_dat below) strips the char before \x01
            f.write(point_field_names.encode() + b"\n\x01")
            f.write(cell_field_names.encode() + b"\n\x01")
            # mesh: points (f32), conn/offsets/types (u64)
            pts = grid.node_coords(np.float32).reshape(-1, 3)
            f.write(pts.astype("<f4").tobytes())
            conn = hex_connectivity(grid.nn).astype("<u8")
            f.write(conn.tobytes())
            offs = (8 * np.arange(1, ncells + 1)).astype("<u8")
            f.write(offs.tobytes())
            f.write(np.full(ncells, 12, "<u8").tobytes())

    def write_fields(
        self,
        itr: int,
        point_fields: Sequence[np.ndarray],
        cell_fields: Sequence[np.ndarray],
    ) -> None:
        """Append one timestep (MPIIO::WriteVTK, MPIIO.cc:147-205)."""
        assert len(point_fields) == self.n_pfields
        assert len(cell_fields) == self.n_cfields
        with open(self.path, "ab") as f:
            f.write(struct.pack("<Q", itr))
            for arr in point_fields:
                f.write(
                    np.asarray(arr, dtype="<f4").ravel().tobytes()
                )
            for arr in cell_fields:
                f.write(
                    np.asarray(arr, dtype="<f4").ravel().tobytes()
                )


def read_dat(path: str):
    """Parse a .dat file (ours or the reference's); returns a dict with
    the mesh and the list of per-timestep field dicts.  The offline
    decoder the reference ships as bin2vtu_v3.py, as a library."""

    def read_string(f):
        out = b""
        while True:
            c = f.read(1)
            if not c:
                raise EOFError("file ended while scanning for string")
            if c == b"\x01":
                return out[:-1].decode("utf-8", errors="replace")
            out += c

    with open(path, "rb") as f:
        info = read_string(f)
        (ndom,) = struct.unpack("<Q", f.read(8))
        hdr = struct.unpack(f"<{4 * ndom}Q", f.read(8 * 4 * ndom))
        npoints = list(hdr[0:ndom])
        ncells = list(hdr[ndom : 2 * ndom])
        npf = list(hdr[2 * ndom : 3 * ndom])
        ncf = list(hdr[3 * ndom : 4 * ndom])
        (npe,) = struct.unpack("<Q", f.read(8))
        pf_names = [s.strip() for s in read_string(f).split(",")]
        cf_names = [s.strip() for s in read_string(f).split(",")]

        nP, nC = sum(npoints), sum(ncells)
        points = np.frombuffer(f.read(12 * nP), "<f4").reshape(-1, 3)
        conn = np.frombuffer(f.read(8 * npe * nC), "<u8").reshape(-1, npe)
        offsets = np.frombuffer(f.read(8 * nC), "<u8")
        types = np.frombuffer(f.read(8 * nC), "<u8")

        steps = []
        while True:
            raw = f.read(8)
            if len(raw) < 8:
                break
            (itr,) = struct.unpack("<Q", raw)
            pfields = {}
            cfields = {}
            for d in range(ndom):
                for j in range(npf[d]):
                    data = np.frombuffer(f.read(4 * npoints[d]), "<f4")
                    name = pf_names[j] if j < len(pf_names) else f"P{j}"
                    pfields[name] = data
                for j in range(ncf[d]):
                    data = np.frombuffer(f.read(4 * ncells[d]), "<f4")
                    name = cf_names[j] if j < len(cf_names) else f"C{j}"
                    cfields[name] = data
            steps.append(
                {"itr": itr, "point_fields": pfields,
                 "cell_fields": cfields}
            )

    return {
        "info": info,
        "points": points,
        "conn": conn,
        "offsets": offsets,
        "types": types,
        "steps": steps,
    }


def dat_to_vtu(dat_path: str, out_prefix: str, dataset: int = 0) -> str:
    """Offline .dat -> .vtu conversion (bin2vtu_v3.py equivalent):
    emits `{out_prefix}_{dataset:05d}.vtu` for the requested dataset index."""
    import base64

    d = read_dat(dat_path)
    if dataset >= len(d["steps"]):
        raise IndexError(
            f"dataset {dataset} not found ({len(d['steps'])} present)"
        )
    step = d["steps"][dataset]
    out = f"{out_prefix}_{dataset:05d}.vtu"

    def b64(data: bytes) -> bytes:
        return base64.b64encode(
            struct.pack("<Q", len(data))
        ) + base64.b64encode(data)

    npoints = d["points"].shape[0]
    ncells = d["conn"].shape[0]
    types = np.where(d["types"] == 1000, 12, d["types"]).astype("<u8")
    with open(out, "wb") as f:
        f.write(b'<?xml version="1.0"?>\n')
        f.write(
            b'<VTKFile type="UnstructuredGrid" version="1.0" '
            b'header_type="UInt64" byte_order="LittleEndian">\n'
            b"<UnstructuredGrid>\n"
        )
        f.write(
            f'\t<Piece NumberOfPoints="{npoints}" '
            f'NumberOfCells="{ncells}">\n'.encode()
        )
        f.write(b"\t\t<Points>\n\t\t\t<DataArray type=\"Float32\" "
                b"NumberOfComponents=\"3\" format=\"binary\">\n")
        f.write(b64(d["points"].astype("<f4").tobytes()))
        f.write(b"\n\t\t\t</DataArray>\n\t\t</Points>\n\t\t<Cells>\n")
        for name, arr in (
            ("connectivity", d["conn"].astype("<u8")),
            ("offsets", d["offsets"].astype("<u8")),
            ("types", types),
        ):
            f.write(
                f'\t\t\t<DataArray type="UInt64" Name="{name}" '
                f'format="binary">\n'.encode()
            )
            f.write(b64(arr.tobytes()))
            f.write(b"\n\t\t\t</DataArray>\n")
        f.write(b"\t\t</Cells>\n")
        f.write(b'\t\t<PointData Scalars="scalars">\n')
        for name, arr in step["point_fields"].items():
            f.write(
                f'\t\t\t<DataArray type="Float32" Name="{name}" '
                f'format="binary">\n'.encode()
            )
            f.write(b64(arr.astype("<f4").tobytes()))
            f.write(b"\n\t\t\t</DataArray>\n")
        f.write(b"\t\t</PointData>\n")
        f.write(b'\t\t<CellData Scalars="scalars">\n')
        for name, arr in step["cell_fields"].items():
            f.write(
                f'\t\t\t<DataArray type="Float32" Name="{name}" '
                f'format="binary">\n'.encode()
            )
            f.write(b64(arr.astype("<f4").tobytes()))
            f.write(b"\n\t\t\t</DataArray>\n")
        f.write(b"\t\t</CellData>\n")
        f.write(b"\t</Piece>\n</UnstructuredGrid>\n</VTKFile>")
    return out
