"""ctypes binding of libo3fs, the C client of the HttpFS gateway.

The library is the port's copy of the reference's native client
(`csrc/libo3fs/o3fs.c` and `o3fs.h`, WebHDFS over POSIX sockets), built
with gcc by `cuda_build` into `_build/` on the first `library()` call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

#: o3fsOpenFile flags (o3fs.h)
O3FS_RDONLY = 1
O3FS_WRONLY = 2


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library with the signatures of o3fs.h."""
    from ozone_tpu_torch import cuda_build

    lib = cuda_build.load("o3fs")
    vp, cp, i64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
    lib.o3fsConnect.restype = vp
    lib.o3fsConnect.argtypes = [cp, ctypes.c_int]
    lib.o3fsDisconnect.argtypes = [vp]
    lib.o3fsOpenFile.restype = vp
    lib.o3fsOpenFile.argtypes = [vp, cp, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_short, ctypes.c_int32]
    lib.o3fsCloseFile.argtypes = [vp, vp]
    lib.o3fsWrite.restype = i64
    lib.o3fsWrite.argtypes = [vp, vp, vp, i64]
    lib.o3fsRead.restype = i64
    lib.o3fsRead.argtypes = [vp, vp, vp, i64]
    lib.o3fsSeek.argtypes = [vp, vp, i64]
    lib.o3fsTell.restype = i64
    lib.o3fsTell.argtypes = [vp, vp]
    lib.o3fsCreateDirectory.argtypes = [vp, cp]
    lib.o3fsDelete.argtypes = [vp, cp, ctypes.c_int]
    lib.o3fsRename.argtypes = [vp, cp, cp]
    lib.o3fsGetPathInfo.restype = i64
    lib.o3fsGetPathInfo.argtypes = [vp, cp, ctypes.POINTER(ctypes.c_int)]
    lib.o3fsExists.argtypes = [vp, cp]
    return lib
