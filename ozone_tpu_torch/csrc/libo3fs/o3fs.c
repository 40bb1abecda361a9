/* libo3fs implementation: WebHDFS over POSIX sockets.
 *
 * See o3fs.h. A copy of ozone_tpu/native/libo3fs/o3fs.c (the reference's
 * native-client libo3fs wraps libhdfs); the transport is the WebHDFS REST
 * dialect served by ozone_tpu_torch/gateway/httpfs.py:
 *   GET    /webhdfs/v1<path>?op=OPEN | GETFILESTATUS
 *   PUT    ?op=CREATE (307 -> data endpoint) | MKDIRS | RENAME
 *   DELETE ?op=DELETE[&recursive=true]
 */
#define _GNU_SOURCE 1 /* memmem */
#include "o3fs.h"

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#define PREFIX "/webhdfs/v1"

struct o3fs_internal {
  char host[256];
  int port;
};

struct o3fsFile_internal {
  char path[1024];
  int flags;
  /* write buffer (whole-file semantics) */
  unsigned char *wbuf;
  size_t wlen, wcap;
  /* read buffer: whole object fetched at open */
  unsigned char *rbuf;
  size_t rlen, rpos;
};

/* ----------------------------------------------------------- http core */

typedef struct {
  int status;
  unsigned char *body;
  size_t body_len;
  char location[1024];
} http_resp;

static int dial(const char *host, int port) {
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  struct addrinfo hints, *res = NULL;
  memset(&hints, 0, sizeof hints);
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host, portstr, &hints, &res) != 0) {
    errno = EHOSTUNREACH;
    return -1;
  }
  int fd = -1;
  struct addrinfo *ai;
  for (ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  }
  return fd;
}

static int send_all(int fd, const void *buf, size_t n) {
  const char *p = (const char *)buf;
  while (n > 0) {
    ssize_t w = send(fd, p, n, 0);
    if (w <= 0) return -1;
    p += w;
    n -= (size_t)w;
  }
  return 0;
}

/* One HTTP round trip. method/path_query are caller-formatted; body may
 * be NULL. Fills resp (body malloc'd, caller frees). Connection: close
 * keeps the parse trivial and the gateway threads per-request anyway. */
static int http_request(const char *host, int port, const char *method,
                        const char *path_query, const void *body,
                        size_t body_len, http_resp *resp) {
  memset(resp, 0, sizeof *resp);
  int fd = dial(host, port);
  if (fd < 0) return -1;

  char head[2048];
  int n = snprintf(head, sizeof head,
                   "%s %s HTTP/1.1\r\n"
                   "Host: %s:%d\r\n"
                   "Content-Length: %zu\r\n"
                   "Connection: close\r\n\r\n",
                   method, path_query, host, port, body_len);
  if (n <= 0 || send_all(fd, head, (size_t)n) != 0 ||
      (body_len > 0 && send_all(fd, body, body_len) != 0)) {
    close(fd);
    return -1;
  }

  /* read entire response */
  size_t cap = 8192, len = 0;
  unsigned char *buf = (unsigned char *)malloc(cap);
  if (!buf) {
    close(fd);
    return -1;
  }
  for (;;) {
    if (len == cap) {
      cap *= 2;
      unsigned char *nb = (unsigned char *)realloc(buf, cap);
      if (!nb) {
        free(buf);
        close(fd);
        return -1;
      }
      buf = nb;
    }
    ssize_t r = recv(fd, buf + len, cap - len, 0);
    if (r < 0) {
      free(buf);
      close(fd);
      return -1;
    }
    if (r == 0) break;
    len += (size_t)r;
  }
  close(fd);

  /* parse status line + headers */
  unsigned char *hdr_end = (unsigned char *)memmem(buf, len, "\r\n\r\n", 4);
  if (!hdr_end || sscanf((char *)buf, "HTTP/1.%*c %d", &resp->status) != 1) {
    free(buf);
    errno = EPROTO;
    return -1;
  }
  size_t hlen = (size_t)(hdr_end - buf) + 4;
  /* Location header (for the CREATE 307 dance) */
  char *loc = (char *)memmem(buf, hlen, "Location: ", 10);
  if (loc) {
    char *end = strstr(loc, "\r\n");
    size_t m = end ? (size_t)(end - loc - 10) : 0;
    if (m >= sizeof resp->location) m = sizeof resp->location - 1;
    memcpy(resp->location, loc + 10, m);
    resp->location[m] = 0;
  }
  resp->body_len = len - hlen;
  resp->body = (unsigned char *)malloc(resp->body_len + 1);
  if (!resp->body) {
    free(buf);
    return -1;
  }
  memcpy(resp->body, buf + hlen, resp->body_len);
  resp->body[resp->body_len] = 0;
  free(buf);
  return 0;
}

/* percent-encode a path (conservative: keep [A-Za-z0-9/._-]) */
static void enc_path(const char *in, char *out, size_t cap) {
  static const char hex[] = "0123456789ABCDEF";
  size_t o = 0;
  size_t i;
  for (i = 0; in[i] && o + 4 < cap; i++) {
    unsigned char c = (unsigned char)in[i];
    if ((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
        (c >= '0' && c <= '9') || c == '/' || c == '.' || c == '_' ||
        c == '-') {
      out[o++] = (char)c;
    } else {
      out[o++] = '%';
      out[o++] = hex[c >> 4];
      out[o++] = hex[c & 15];
    }
  }
  out[o] = 0;
}

/* ----------------------------------------------------------- lifecycle */

o3fsFS o3fsConnect(const char *host, int port) {
  o3fsFS fs = (o3fsFS)calloc(1, sizeof *fs);
  if (!fs) return NULL;
  snprintf(fs->host, sizeof fs->host, "%s", host);
  fs->port = port;
  return fs;
}

int o3fsDisconnect(o3fsFS fs) {
  free(fs);
  return 0;
}

/* ----------------------------------------------------------- files */

o3fsFile o3fsOpenFile(o3fsFS fs, const char *path, int flags,
                      int bufferSize, short replication,
                      int32_t blocksize) {
  (void)bufferSize;
  (void)replication;
  (void)blocksize;
  if (!fs || !path || (flags != O3FS_RDONLY && flags != O3FS_WRONLY)) {
    errno = EINVAL;
    return NULL;
  }
  o3fsFile f = (o3fsFile)calloc(1, sizeof *f);
  if (!f) return NULL;
  snprintf(f->path, sizeof f->path, "%s", path);
  f->flags = flags;
  if (flags == O3FS_RDONLY) {
    char ep[1536], url[2048];
    enc_path(path, ep, sizeof ep);
    snprintf(url, sizeof url, PREFIX "%s?op=OPEN", ep);
    http_resp r;
    if (http_request(fs->host, fs->port, "GET", url, NULL, 0, &r) != 0) {
      free(f);
      return NULL;
    }
    if (r.status != 200) {
      free(r.body);
      free(f);
      errno = ENOENT;
      return NULL;
    }
    f->rbuf = r.body;
    f->rlen = r.body_len;
  }
  return f;
}

int64_t o3fsWrite(o3fsFS fs, o3fsFile f, const void *buffer,
                  int64_t length) {
  (void)fs;
  if (!f || f->flags != O3FS_WRONLY || length < 0) {
    errno = EINVAL;
    return -1;
  }
  if (f->wlen + (size_t)length > f->wcap) {
    size_t ncap = f->wcap ? f->wcap : 65536;
    while (ncap < f->wlen + (size_t)length) ncap *= 2;
    unsigned char *nb = (unsigned char *)realloc(f->wbuf, ncap);
    if (!nb) return -1;
    f->wbuf = nb;
    f->wcap = ncap;
  }
  memcpy(f->wbuf + f->wlen, buffer, (size_t)length);
  f->wlen += (size_t)length;
  return length;
}

int64_t o3fsRead(o3fsFS fs, o3fsFile f, void *buffer, int64_t length) {
  (void)fs;
  if (!f || f->flags != O3FS_RDONLY || length < 0) {
    errno = EINVAL;
    return -1;
  }
  size_t left = f->rlen - f->rpos;
  size_t n = (size_t)length < left ? (size_t)length : left;
  memcpy(buffer, f->rbuf + f->rpos, n);
  f->rpos += n;
  return (int64_t)n;
}

int o3fsSeek(o3fsFS fs, o3fsFile f, int64_t pos) {
  (void)fs;
  if (!f || f->flags != O3FS_RDONLY || pos < 0 || (size_t)pos > f->rlen) {
    errno = EINVAL;
    return -1;
  }
  f->rpos = (size_t)pos;
  return 0;
}

int64_t o3fsTell(o3fsFS fs, o3fsFile f) {
  (void)fs;
  if (!f) {
    errno = EINVAL;
    return -1;
  }
  return (int64_t)(f->flags == O3FS_RDONLY ? f->rpos : f->wlen);
}

int o3fsCloseFile(o3fsFS fs, o3fsFile f) {
  if (!f) return 0;
  int rc = 0;
  if (f->flags == O3FS_WRONLY) {
    /* WebHDFS two-step create: PUT -> 307 Location -> PUT with data */
    char ep[1536], url[2048];
    enc_path(f->path, ep, sizeof ep);
    snprintf(url, sizeof url, PREFIX "%s?op=CREATE&overwrite=true", ep);
    http_resp r1;
    rc = http_request(fs->host, fs->port, "PUT", url, NULL, 0, &r1);
    if (rc == 0 && r1.status == 307 && r1.location[0]) {
      /* location is absolute (http://host:port/path?query): reuse the
       * path+query part against our own host/port */
      const char *pq = strstr(r1.location, "://");
      pq = pq ? strchr(pq + 3, '/') : r1.location;
      http_resp r2;
      rc = http_request(fs->host, fs->port, "PUT", pq ? pq : r1.location,
                        f->wbuf, f->wlen, &r2);
      if (rc == 0 && r2.status / 100 != 2) {
        errno = EIO;
        rc = -1;
      }
      free(r2.body);
    } else if (rc == 0) {
      errno = EIO;
      rc = -1;
    }
    free(r1.body);
  }
  free(f->wbuf);
  free(f->rbuf);
  free(f);
  return rc;
}

/* ----------------------------------------------------------- namespace */

static int simple_op(o3fsFS fs, const char *method, const char *path,
                     const char *query, http_resp *out) {
  char ep[1536], url[2048];
  enc_path(path, ep, sizeof ep);
  snprintf(url, sizeof url, PREFIX "%s?%s", ep, query);
  return http_request(fs->host, fs->port, method, url, NULL, 0, out);
}

int o3fsCreateDirectory(o3fsFS fs, const char *path) {
  http_resp r;
  if (simple_op(fs, "PUT", path, "op=MKDIRS", &r) != 0) return -1;
  int ok = r.status == 200;
  free(r.body);
  if (!ok) errno = EIO;
  return ok ? 0 : -1;
}

int o3fsDelete(o3fsFS fs, const char *path, int recursive) {
  http_resp r;
  if (simple_op(fs, "DELETE", path,
                recursive ? "op=DELETE&recursive=true" : "op=DELETE",
                &r) != 0)
    return -1;
  int ok = r.status == 200;
  free(r.body);
  if (!ok) errno = EIO;
  return ok ? 0 : -1;
}

int o3fsRename(o3fsFS fs, const char *oldPath, const char *newPath) {
  char epd[1536], q[1600];
  enc_path(newPath, epd, sizeof epd);
  snprintf(q, sizeof q, "op=RENAME&destination=%s", epd);
  http_resp r;
  if (simple_op(fs, "PUT", oldPath, q, &r) != 0) return -1;
  int ok = r.status == 200;
  free(r.body);
  if (!ok) errno = EIO;
  return ok ? 0 : -1;
}

int64_t o3fsGetPathInfo(o3fsFS fs, const char *path, int *isDir) {
  http_resp r;
  if (simple_op(fs, "GET", path, "op=GETFILESTATUS", &r) != 0) return -1;
  if (r.status != 200) {
    free(r.body);
    errno = ENOENT;
    return -1;
  }
  /* minimal JSON probing: "length":N and "type":"DIRECTORY" */
  int64_t len = 0;
  const char *lp = strstr((const char *)r.body, "\"length\":");
  if (lp) len = (int64_t)strtoll(lp + 9, NULL, 10);
  if (isDir)
    *isDir = strstr((const char *)r.body, "\"DIRECTORY\"") != NULL;
  free(r.body);
  return len;
}

int o3fsExists(o3fsFS fs, const char *path) {
  int64_t n = o3fsGetPathInfo(fs, path, NULL);
  return n >= 0 ? 0 : -1;
}
