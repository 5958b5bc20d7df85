// gpu-domain-daemon — per-node ComputeDomain rendezvous & readiness daemon
// (the port's copy of native/src/slice_daemon.cc, with the same protocol).
//
// The compute-domain daemon of each domain member runs this binary, as
// NVIDIA's compute-domain daemon runs nvidia-imex. IMEX brokers GPU-memory
// export across a multi-node NVLink fabric; this daemon does what the
// control plane consumes:
//
//   1. hold the clique identity (clique_id, worker index) for this host,
//   2. rendezvous with the peer daemons listed in a nodes config (stable
//      DNS names or raw IPs), re-read on SIGUSR1,
//   3. answer a local status query, the READY probe the daemon pod's
//      startup and liveness probes run.
//
// Protocol (newline-terminated ASCII over TCP):
//   "Q"                   -> "READY peers=<reachable>/<total>\n" | "NOT_READY ...\n"
//   "H <clique_id> <idx>" -> "OK <my_clique_id> <my_idx>\n"  (peer hello)
//
// Readiness: the daemon is READY once it serves and has loaded its
// config: daemons start eagerly and workload pods release on *local*
// daemon readiness. Peer reachability is reported, not gated on.
//
// Usage:
//   gpu-domain-daemon --config <file>       run (config: key=value lines)
//   gpu-domain-daemon --check --port <p>    probe localhost; exit 0 iff READY
//
// Config keys: node_ip, port, nodes_config, clique_id, worker_index.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <signal.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

std::atomic<bool> g_stop{false};
std::atomic<bool> g_reload{false};

void OnSignal(int sig) {
  if (sig == SIGUSR1) {
    g_reload = true;
  } else {
    g_stop = true;
  }
}

struct Config {
  std::string node_ip = "0.0.0.0";
  int port = 7551;
  std::string nodes_config;
  std::string clique_id;
  int worker_index = 0;
};

bool LoadConfig(const std::string& path, Config* out) {
  std::ifstream f(path);
  if (!f.good()) return false;
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string key = line.substr(0, eq), val = line.substr(eq + 1);
    if (key == "node_ip") out->node_ip = val;
    else if (key == "port") out->port = atoi(val.c_str());
    else if (key == "nodes_config") out->nodes_config = val;
    else if (key == "clique_id") out->clique_id = val;
    else if (key == "worker_index") out->worker_index = atoi(val.c_str());
  }
  return true;
}

// Peer list: one "host[:port]" per line (DNS names in the default mode —
// stable gpu-cd-daemon-%04d names — or raw IPs in legacy mode).
std::vector<std::string> LoadPeers(const std::string& path) {
  std::vector<std::string> peers;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\r' || line.back() == ' '))
      line.pop_back();
    if (!line.empty() && line[0] != '#') peers.push_back(line);
  }
  return peers;
}

int DialPeer(const std::string& peer, int default_port, int timeout_ms) {
  std::string host = peer;
  int port = default_port;
  auto colon = peer.rfind(':');
  if (colon != std::string::npos && peer.find(':') == colon) {  // not IPv6
    host = peer.substr(0, colon);
    port = atoi(peer.c_str() + colon + 1);
  }
  struct addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints, &res) != 0)
    return -1;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd >= 0) {
    struct timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    if (connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
      close(fd);
      fd = -1;
    }
  }
  freeaddrinfo(res);
  return fd;
}

class Daemon {
 public:
  explicit Daemon(const Config& cfg) : cfg_(cfg) {}

  bool Start() {
    listen_fd_ = socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return false;
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    struct sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)cfg_.port);
    addr.sin_addr.s_addr = INADDR_ANY;
    if (bind(listen_fd_, (struct sockaddr*)&addr, sizeof(addr)) != 0) return false;
    if (listen(listen_fd_, 16) != 0) return false;
    ready_ = true;
    server_thread_ = std::thread([this] { Serve(); });
    sweep_thread_ = std::thread([this] { SweepPeers(); });
    return true;
  }

  void Stop() {
    ready_ = false;
    if (listen_fd_ >= 0) {
      shutdown(listen_fd_, SHUT_RDWR);
      close(listen_fd_);
      listen_fd_ = -1;
    }
    if (server_thread_.joinable()) server_thread_.join();
    if (sweep_thread_.joinable()) sweep_thread_.join();
  }

 private:
  void Serve() {
    while (!g_stop) {
      int fd = accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (g_stop) break;
        // Back off on persistent accept errors (EMFILE) instead of
        // busy-spinning a core.
        usleep(10 * 1000);
        continue;
      }
      // Bound the inbound read the same way outbound dials are bounded
      // (DialPeer sets SO_RCVTIMEO): without this, one idle client — a
      // port scanner, a stalled TCP connection — blocks the accept loop
      // indefinitely, --check probes time out, and the node flaps
      // NotReady even though the daemon is healthy.
      struct timeval tv{1, 0};
      setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      char buf[256];
      ssize_t n = read(fd, buf, sizeof(buf) - 1);
      if (n > 0) {
        buf[n] = '\0';
        std::string reply = Handle(std::string(buf));
        (void)!write(fd, reply.data(), reply.size());
      }
      close(fd);
    }
  }

  std::string Handle(const std::string& req) {
    if (!req.empty() && req[0] == 'Q') {
      std::lock_guard<std::mutex> l(mu_);
      char out[128];
      snprintf(out, sizeof(out), "%s peers=%d/%d\n",
               ready_ ? "READY" : "NOT_READY", reachable_, total_peers_);
      return out;
    }
    if (!req.empty() && req[0] == 'H') {
      char out[160];
      snprintf(out, sizeof(out), "OK %s %d\n", cfg_.clique_id.c_str(),
               cfg_.worker_index);
      return out;
    }
    return "ERR unknown command\n";
  }

  void SweepPeers() {
    while (!g_stop) {
      if (g_reload.exchange(false)) {
        // SIGUSR1: membership changed; re-read the peer list now.
      }
      std::vector<std::string> peers;
      if (!cfg_.nodes_config.empty()) peers = LoadPeers(cfg_.nodes_config);
      int ok = 0;
      for (const auto& p : peers) {
        int fd = DialPeer(p, cfg_.port, 500);
        if (fd >= 0) {
          std::string hello = "H " + cfg_.clique_id + " " +
                              std::to_string(cfg_.worker_index) + "\n";
          if (write(fd, hello.data(), hello.size()) > 0) {
            char buf[160];
            ssize_t n = read(fd, buf, sizeof(buf) - 1);
            if (n > 2 && strncmp(buf, "OK", 2) == 0) ++ok;
          }
          close(fd);
        }
      }
      {
        std::lock_guard<std::mutex> l(mu_);
        reachable_ = ok;
        total_peers_ = (int)peers.size();
      }
      for (int i = 0; i < 20 && !g_stop && !g_reload; ++i)
        usleep(100 * 1000);
    }
  }

  Config cfg_;
  // Closed by Stop() while Serve() loops on accept: atomic so the
  // shutdown handoff is not a data race.
  std::atomic<int> listen_fd_{-1};
  std::thread server_thread_, sweep_thread_;
  std::mutex mu_;
  // Written by Start()/Stop() on the main thread, read by connection
  // handlers — atomic, not plain.
  std::atomic<bool> ready_{false};
  int reachable_ = 0;
  int total_peers_ = 0;
};

int RunCheck(int port) {
  int fd = DialPeer("127.0.0.1", port, 1000);
  if (fd < 0) {
    fprintf(stderr, "check: cannot connect to 127.0.0.1:%d\n", port);
    return 1;
  }
  (void)!write(fd, "Q\n", 2);
  char buf[128];
  ssize_t n = read(fd, buf, sizeof(buf) - 1);
  close(fd);
  if (n <= 0) return 1;
  buf[n] = '\0';
  printf("%s", buf);
  return strncmp(buf, "READY", 5) == 0 ? 0 : 1;
}

}  // namespace

int main(int argc, char** argv) {
  std::string config_path;
  bool check = false;
  int check_port = 7551;
  for (int i = 1; i < argc; ++i) {
    if (strcmp(argv[i], "--config") == 0 && i + 1 < argc) {
      config_path = argv[++i];
    } else if (strcmp(argv[i], "--check") == 0) {
      check = true;
    } else if (strcmp(argv[i], "--port") == 0 && i + 1 < argc) {
      check_port = atoi(argv[++i]);
    } else {
      fprintf(stderr,
              "usage: gpu-domain-daemon --config <file> | --check --port <p>\n");
      return 2;
    }
  }
  if (check) return RunCheck(check_port);

  // Handlers before any config I/O (and only on the run path — the
  // --check probe keeps default dispositions so Ctrl-C still kills it):
  // the wrapper's update loop may SIGUSR1 us the moment we exist, and the
  // default disposition for SIGUSR1 is process death ("child exited
  // unexpectedly (rc=-10)" during startup). The wrapper's ProcessManager
  // also holds signals until the first READY probe.
  signal(SIGTERM, OnSignal);
  signal(SIGINT, OnSignal);
  signal(SIGUSR1, OnSignal);

  if (config_path.empty()) {
    fprintf(stderr, "gpu-domain-daemon: --config required\n");
    return 2;
  }

  Config cfg;
  if (!LoadConfig(config_path, &cfg)) {
    fprintf(stderr, "gpu-domain-daemon: cannot read config %s\n",
            config_path.c_str());
    return 1;
  }

  Daemon d(cfg);
  if (!d.Start()) {
    fprintf(stderr, "gpu-domain-daemon: failed to bind port %d\n", cfg.port);
    return 1;
  }
  fprintf(stderr, "gpu-domain-daemon: serving on port %d (clique_id=%s worker=%d)\n",
          cfg.port, cfg.clique_id.c_str(), cfg.worker_index);
  while (!g_stop) usleep(100 * 1000);
  d.Stop();
  return 0;
}
