/* Read a file from the object store to stdout via libo3fs.
 * Usage: libo3fs_read <host> <port> <o3fs-path>
 * The port's copy of ozone_tpu/native/libo3fs/examples/libo3fs_read.c,
 * built against csrc/libo3fs/o3fs.c. Mirror of the reference example
 * hadoop-ozone/native-client/libo3fs-examples/libo3fs_read.c. */
#include <stdio.h>
#include <stdlib.h>

#include "../o3fs.h"

int main(int argc, char **argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s host port o3fs-path\n", argv[0]);
    return 2;
  }
  o3fsFS fs = o3fsConnect(argv[1], atoi(argv[2]));
  if (!fs) {
    perror("o3fsConnect");
    return 1;
  }
  o3fsFile f = o3fsOpenFile(fs, argv[3], O3FS_RDONLY, 0, 0, 0);
  if (!f) {
    perror("o3fsOpenFile");
    return 1;
  }
  char buf[65536];
  int64_t n;
  while ((n = o3fsRead(fs, f, buf, sizeof buf)) > 0)
    fwrite(buf, 1, (size_t)n, stdout);
  o3fsCloseFile(fs, f);
  o3fsDisconnect(fs);
  return 0;
}
