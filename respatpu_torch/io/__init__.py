from .mtx import MtxHeader, load_coo, load_csr, read_header, write_mtx

__all__ = ["MtxHeader", "load_coo", "load_csr", "read_header", "write_mtx"]
