/* Write a local file into the object store via libo3fs.
 * Usage: libo3fs_write <host> <port> <o3fs-path> <local-file>
 * The port's copy of ozone_tpu/native/libo3fs/examples/libo3fs_write.c,
 * built against csrc/libo3fs/o3fs.c. Mirror of the reference example
 * hadoop-ozone/native-client/libo3fs-examples/libo3fs_write.c. */
#include <stdio.h>
#include <stdlib.h>

#include "../o3fs.h"

int main(int argc, char **argv) {
  if (argc != 5) {
    fprintf(stderr, "usage: %s host port o3fs-path local-file\n", argv[0]);
    return 2;
  }
  o3fsFS fs = o3fsConnect(argv[1], atoi(argv[2]));
  if (!fs) {
    perror("o3fsConnect");
    return 1;
  }
  FILE *in = fopen(argv[4], "rb");
  if (!in) {
    perror("fopen");
    return 1;
  }
  o3fsFile f = o3fsOpenFile(fs, argv[3], O3FS_WRONLY, 0, 0, 0);
  if (!f) {
    perror("o3fsOpenFile");
    return 1;
  }
  char buf[65536];
  size_t n;
  long total = 0;
  while ((n = fread(buf, 1, sizeof buf, in)) > 0) {
    if (o3fsWrite(fs, f, buf, (int64_t)n) < 0) {
      perror("o3fsWrite");
      return 1;
    }
    total += (long)n;
  }
  fclose(in);
  if (o3fsCloseFile(fs, f) != 0) {
    perror("o3fsCloseFile");
    return 1;
  }
  printf("wrote %ld bytes to %s\n", total, argv[3]);
  o3fsDisconnect(fs);
  return 0;
}
