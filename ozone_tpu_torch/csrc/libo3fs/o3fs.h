/* libo3fs: C client for the ozone-tpu object store filesystem.
 *
 * Role analog of the reference's native client
 * (hadoop-ozone/native-client/libo3fs/o3fs.h — a thin C API over
 * libhdfs for the o3fs:// scheme). This build has no JVM, so the C
 * client speaks the WebHDFS-compatible REST protocol of the httpfs
 * gateway (ozone_tpu_torch/gateway/httpfs.py) over plain POSIX sockets —
 * same API shape, zero non-libc dependencies.
 *
 * All functions return 0 (or a valid handle) on success; -1/NULL on
 * failure with errno set where meaningful.
 */
#ifndef O3FS_H
#define O3FS_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct o3fs_internal *o3fsFS;
typedef struct o3fsFile_internal *o3fsFile;

#define O3FS_RDONLY 1
#define O3FS_WRONLY 2

/* Connect to an httpfs gateway endpoint (no I/O happens until the
 * first operation; the handle just records host/port). */
o3fsFS o3fsConnect(const char *host, int port);
int o3fsDisconnect(o3fsFS fs);

/* Open for reading (O3FS_RDONLY) or writing (O3FS_WRONLY). Writes are
 * buffered client-side and shipped as one WebHDFS CREATE (two-step 307
 * dance) at close — the same whole-file semantics as the reference's
 * o3fs wrapper. bufferSize/replication/blocksize are accepted for
 * libhdfs API compatibility and ignored. */
o3fsFile o3fsOpenFile(o3fsFS fs, const char *path, int flags,
                      int bufferSize, short replication, int32_t blocksize);
int o3fsCloseFile(o3fsFS fs, o3fsFile file);

int64_t o3fsWrite(o3fsFS fs, o3fsFile file, const void *buffer,
                  int64_t length);
int64_t o3fsRead(o3fsFS fs, o3fsFile file, void *buffer, int64_t length);
int o3fsSeek(o3fsFS fs, o3fsFile file, int64_t pos);
int64_t o3fsTell(o3fsFS fs, o3fsFile file);

int o3fsCreateDirectory(o3fsFS fs, const char *path);
int o3fsDelete(o3fsFS fs, const char *path, int recursive);
int o3fsRename(o3fsFS fs, const char *oldPath, const char *newPath);
/* Returns file length, or -1 if the path does not exist. isDir (may be
 * NULL) receives 1 for directories. */
int64_t o3fsGetPathInfo(o3fsFS fs, const char *path, int *isDir);
int o3fsExists(o3fsFS fs, const char *path);

#ifdef __cplusplus
}
#endif

#endif /* O3FS_H */
