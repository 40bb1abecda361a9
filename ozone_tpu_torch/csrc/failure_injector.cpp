// Filesystem failure injector: an LD_PRELOAD interposer for fault tests.
//
// The port's copy of ozone_tpu/native/failure_injector.cpp, the role
// analog of the reference's C++ fault-injection-service
// (tools/fault-injection-service/FileSystem/failure_injector.cc and
// failure_injector_fs.cc): intercept filesystem operations under a
// datanode and fail, delay or corrupt them on command. The reference drives
// its shim over gRPC; this one reads a rules file named in OZONE_FI_CONFIG
// again whenever its mtime changes, so the Python controller
// (ozone_tpu_torch/testing/fault_injection.py) retargets faults on a live
// process with no native RPC stack. libc is reached through
// dlsym(RTLD_NEXT); calls on paths no rule names pass through untouched.
//
// Rule grammar, one per line:
//   <op> <path-prefix> <action> [param]
// op:      open | read | write | fsync | rename | unlink | any
// action:  fail <errno-name>   -> the call returns -1 with that errno
//          delay <millis>      -> the call is delayed, then forwarded
//          corrupt             -> (write) the first byte of the payload is
//                                 bit-flipped before it reaches the disk
// Lines starting with '#' are comments.
//
// Built by ozone_tpu_torch/cuda_build.py (g++ -O2 -shared -fPIC -ldl) into
// ozone_tpu_torch/_build/; never loaded into the building process.

#define _GNU_SOURCE 1
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

struct Rule {
  std::string op;      // open/read/write/fsync/rename/unlink/any
  std::string prefix;  // path prefix to match
  std::string action;  // fail/delay/corrupt
  int param = 0;       // errno or millis
};

pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
std::vector<Rule>* g_rules = nullptr;
time_t g_mtime = 0;
time_t g_last_check = 0;

// fd -> path registry so read/write/fsync rules can match by path
pthread_mutex_t g_fd_mu = PTHREAD_MUTEX_INITIALIZER;
std::vector<std::string>* g_fd_paths = nullptr;  // indexed by fd

int errno_by_name(const char* name) {
  if (!strcmp(name, "EIO")) return EIO;
  if (!strcmp(name, "ENOSPC")) return ENOSPC;
  if (!strcmp(name, "EACCES")) return EACCES;
  if (!strcmp(name, "ENOENT")) return ENOENT;
  if (!strcmp(name, "EDQUOT")) return EDQUOT;
  if (!strcmp(name, "EROFS")) return EROFS;
  return atoi(name) > 0 ? atoi(name) : EIO;
}

void reload_rules_locked(const char* cfg) {
  FILE* f = fopen(cfg, "r");
  if (!f) return;
  if (!g_rules) g_rules = new std::vector<Rule>();
  g_rules->clear();
  char line[1024];
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    char op[32], prefix[512], action[32], param[64];
    param[0] = 0;
    int n = sscanf(line, "%31s %511s %31s %63s", op, prefix, action, param);
    if (n < 3) continue;
    Rule r;
    r.op = op;
    r.prefix = prefix;
    r.action = action;
    if (r.action == "fail") r.param = errno_by_name(param);
    else if (r.action == "delay") r.param = atoi(param);
    g_rules->push_back(r);
  }
  fclose(f);
}

void maybe_reload() {
  const char* cfg = getenv("OZONE_FI_CONFIG");
  if (!cfg) return;
  time_t now = time(nullptr);
  pthread_mutex_lock(&g_mu);
  if (now != g_last_check) {  // stat at most once per second per change
    g_last_check = now;
    struct stat st;
    if (stat(cfg, &st) == 0 && st.st_mtime != g_mtime) {
      g_mtime = st.st_mtime;
      reload_rules_locked(cfg);
    }
  }
  pthread_mutex_unlock(&g_mu);
}

// returns matched rule (copied) or empty action
Rule match(const char* op, const char* path) {
  Rule hit;
  if (!path) return hit;
  maybe_reload();
  pthread_mutex_lock(&g_mu);
  if (g_rules) {
    for (const Rule& r : *g_rules) {
      if ((r.op == op || r.op == "any") &&
          strncmp(path, r.prefix.c_str(), r.prefix.size()) == 0) {
        hit = r;
        break;
      }
    }
  }
  pthread_mutex_unlock(&g_mu);
  return hit;
}

void do_delay(int millis) {
  struct timespec ts;
  ts.tv_sec = millis / 1000;
  ts.tv_nsec = (long)(millis % 1000) * 1000000L;
  nanosleep(&ts, nullptr);
}

void remember_fd(int fd, const char* path) {
  if (fd < 0 || !path) return;
  pthread_mutex_lock(&g_fd_mu);
  if (!g_fd_paths) g_fd_paths = new std::vector<std::string>();
  if ((size_t)fd >= g_fd_paths->size()) g_fd_paths->resize(fd + 1);
  (*g_fd_paths)[fd] = path;
  pthread_mutex_unlock(&g_fd_mu);
}

std::string fd_path(int fd) {
  std::string out;
  pthread_mutex_lock(&g_fd_mu);
  if (g_fd_paths && fd >= 0 && (size_t)fd < g_fd_paths->size())
    out = (*g_fd_paths)[fd];
  pthread_mutex_unlock(&g_fd_mu);
  return out;
}

void forget_fd(int fd) {
  pthread_mutex_lock(&g_fd_mu);
  if (g_fd_paths && fd >= 0 && (size_t)fd < g_fd_paths->size())
    (*g_fd_paths)[fd].clear();
  pthread_mutex_unlock(&g_fd_mu);
}

typedef int (*open_fn)(const char*, int, ...);
typedef ssize_t (*write_fn)(int, const void*, size_t);
typedef ssize_t (*read_fn)(int, void*, size_t);
typedef ssize_t (*pwrite_fn)(int, const void*, size_t, off_t);
typedef ssize_t (*pread_fn)(int, void*, size_t, off_t);
typedef int (*fsync_fn)(int);
typedef int (*close_fn)(int);
typedef int (*rename_fn)(const char*, const char*);
typedef int (*unlink_fn)(const char*);

}  // namespace

extern "C" {

int open(const char* path, int flags, ...) {
  static open_fn real = (open_fn)dlsym(RTLD_NEXT, "open");
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  Rule r = match("open", path);
  if (r.action == "fail") { errno = r.param; return -1; }
  if (r.action == "delay") do_delay(r.param);
  int fd = real(path, flags, mode);
  remember_fd(fd, path);
  return fd;
}

int open64(const char* path, int flags, ...) {
  static open_fn real = (open_fn)dlsym(RTLD_NEXT, "open64");
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  Rule r = match("open", path);
  if (r.action == "fail") { errno = r.param; return -1; }
  if (r.action == "delay") do_delay(r.param);
  int fd = real(path, flags, mode);
  remember_fd(fd, path);
  return fd;
}

ssize_t write(int fd, const void* buf, size_t count) {
  static write_fn real = (write_fn)dlsym(RTLD_NEXT, "write");
  std::string p = fd_path(fd);
  if (!p.empty()) {
    Rule r = match("write", p.c_str());
    if (r.action == "fail") { errno = r.param; return -1; }
    if (r.action == "delay") do_delay(r.param);
    if (r.action == "corrupt" && count > 0) {
      std::vector<char> copy((const char*)buf, (const char*)buf + count);
      copy[0] ^= 0x01;  // single bit flip: checksums must catch it
      return real(fd, copy.data(), count);
    }
  }
  return real(fd, buf, count);
}

// positional IO shares the write/read rule vocabulary: the datanode's
// chunk store and the native datapath sidecar write through pwrite/pread,
// and a corrupt/fail/delay rule must hit that path exactly as write/read
static ssize_t pwrite_with_rules(pwrite_fn real, int fd, const void* buf,
                                 size_t count, off_t off) {
  std::string p = fd_path(fd);
  if (!p.empty()) {
    Rule r = match("write", p.c_str());
    if (r.action == "fail") { errno = r.param; return -1; }
    if (r.action == "delay") do_delay(r.param);
    if (r.action == "corrupt" && count > 0) {
      std::vector<char> copy((const char*)buf, (const char*)buf + count);
      copy[0] ^= 0x01;  // single bit flip: checksums must catch it
      return real(fd, copy.data(), count, off);
    }
  }
  return real(fd, buf, count, off);
}

ssize_t pwrite(int fd, const void* buf, size_t count, off_t off) {
  static pwrite_fn real = (pwrite_fn)dlsym(RTLD_NEXT, "pwrite");
  return pwrite_with_rules(real, fd, buf, count, off);
}

ssize_t pwrite64(int fd, const void* buf, size_t count, off_t off) {
  static pwrite_fn real = (pwrite_fn)dlsym(RTLD_NEXT, "pwrite64");
  return pwrite_with_rules(real, fd, buf, count, off);
}

static ssize_t pread_with_rules(pread_fn real, int fd, void* buf,
                                size_t count, off_t off) {
  std::string p = fd_path(fd);
  if (!p.empty()) {
    Rule r = match("read", p.c_str());
    if (r.action == "fail") { errno = r.param; return -1; }
    if (r.action == "delay") do_delay(r.param);
  }
  return real(fd, buf, count, off);
}

ssize_t pread(int fd, void* buf, size_t count, off_t off) {
  static pread_fn real = (pread_fn)dlsym(RTLD_NEXT, "pread");
  return pread_with_rules(real, fd, buf, count, off);
}

ssize_t pread64(int fd, void* buf, size_t count, off_t off) {
  static pread_fn real = (pread_fn)dlsym(RTLD_NEXT, "pread64");
  return pread_with_rules(real, fd, buf, count, off);
}

ssize_t read(int fd, void* buf, size_t count) {
  static read_fn real = (read_fn)dlsym(RTLD_NEXT, "read");
  std::string p = fd_path(fd);
  if (!p.empty()) {
    Rule r = match("read", p.c_str());
    if (r.action == "fail") { errno = r.param; return -1; }
    if (r.action == "delay") do_delay(r.param);
  }
  return real(fd, buf, count);
}

int fsync(int fd) {
  static fsync_fn real = (fsync_fn)dlsym(RTLD_NEXT, "fsync");
  std::string p = fd_path(fd);
  if (!p.empty()) {
    Rule r = match("fsync", p.c_str());
    if (r.action == "fail") { errno = r.param; return -1; }
    if (r.action == "delay") do_delay(r.param);
  }
  return real(fd);
}

int close(int fd) {
  // must clear the fd->path registry: the kernel recycles fds, and a
  // stale entry would fire path-scoped rules on unrelated files
  static close_fn real = (close_fn)dlsym(RTLD_NEXT, "close");
  forget_fd(fd);
  return real(fd);
}

int rename(const char* from, const char* to) {
  static rename_fn real = (rename_fn)dlsym(RTLD_NEXT, "rename");
  Rule r = match("rename", from);
  if (r.action == "fail") { errno = r.param; return -1; }
  if (r.action == "delay") do_delay(r.param);
  return real(from, to);
}

int unlink(const char* path) {
  static unlink_fn real = (unlink_fn)dlsym(RTLD_NEXT, "unlink");
  Rule r = match("unlink", path);
  if (r.action == "fail") { errno = r.param; return -1; }
  if (r.action == "delay") do_delay(r.param);
  return real(path);
}

}  // extern "C"
