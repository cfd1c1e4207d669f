// kv_server.cc — the native HTTP KV / rendezvous server of the PyTorch port.
//
// Copy of horovod_tpu/csrc/kv_server.cc, the JAX package's C++ KV server,
// built into the port's own library with hvd_core.cc
// (horovod_tpu_torch/csrc/native.py) and bound by native.NativeKVServer.
//
// Reference (SURVEY.md §2.5): horovod/runner/http/http_server.py:35
// (KVStoreHandler) is the reference's rendezvous/KV transport.  This file
// serves the SAME wire protocol as horovod_tpu_torch/runner/http_server.py's
// Python server (PUT/GET/POST/DELETE, long-poll ?wait=, put-then-await
// POST ?ascope/akey, min-keys scans, batch puts) from C++, so every
// control-plane request — elastic rendezvous, hvd.run's results, the data
// service's registry, the serving fleet's preemption markers and KV tier —
// costs microseconds of host CPU instead of a pure-Python http.server pass.
// chip_smoke.py phase 19 times both servers per request on the card's host.
//
// Differences from the source, each to make the two backends of the port
// answer alike byte for byte (tests/test_torch_kv_server.py):
//   * a scope keeps its keys in insertion order and a scan lists them so,
//     as the Python server's dict does;
//   * scan bodies escape non-ASCII as json.dumps does (\uXXXX, surrogate
//     pairs above the BMP);
//   * a '+' in the query string decodes to a space, as parse_qs does;
// and two for a clean shutdown and for forked children:
//   * hvd_kv_stop waits until every connection thread has left;
//   * the sockets are close-on-exec, and a child forked without exec drops
//     the listening and client sockets it inherited (pthread_atfork), so
//     it neither keeps the port bound nor deadlocks on a lock that a
//     server thread of the parent held at the fork.
//
// Concurrency model mirrors the Python one deliberately: one global store
// mutex, per-scope condition variables (a PUT wakes only its scope's
// waiters), waiters re-fetch their scope's condition every loop iteration so
// a scope delete can retire a condition object without stranding sleepers.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace hvdkv {

// ---------------------------------------------------------------------------
// Small codecs (base64, percent, JSON string-map)
// ---------------------------------------------------------------------------

static const char kB64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

static std::string b64encode(const std::string& in) {
  std::string out;
  out.reserve((in.size() + 2) / 3 * 4);
  size_t i = 0;
  while (i + 2 < in.size()) {
    uint32_t v = (uint8_t)in[i] << 16 | (uint8_t)in[i + 1] << 8 |
                 (uint8_t)in[i + 2];
    out += kB64[v >> 18];
    out += kB64[(v >> 12) & 63];
    out += kB64[(v >> 6) & 63];
    out += kB64[v & 63];
    i += 3;
  }
  if (i + 1 == in.size()) {
    uint32_t v = (uint8_t)in[i] << 16;
    out += kB64[v >> 18];
    out += kB64[(v >> 12) & 63];
    out += "==";
  } else if (i + 2 == in.size()) {
    uint32_t v = (uint8_t)in[i] << 16 | (uint8_t)in[i + 1] << 8;
    out += kB64[v >> 18];
    out += kB64[(v >> 12) & 63];
    out += kB64[(v >> 6) & 63];
    out += '=';
  }
  return out;
}

static int b64val(char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;
}

static bool b64decode(const std::string& in, std::string* out) {
  out->clear();
  uint32_t acc = 0;
  int nbits = 0;
  for (char c : in) {
    if (c == '=' || c == '\n' || c == '\r') continue;
    int v = b64val(c);
    if (v < 0) return false;
    acc = (acc << 6) | v;
    nbits += 6;
    if (nbits >= 8) {
      nbits -= 8;
      out->push_back((char)((acc >> nbits) & 0xff));
    }
  }
  return true;
}

static int hexval(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// `plus`: a '+' is a space (query strings, as parse_qs reads them).
static std::string pct_decode(const std::string& in, bool plus = false) {
  std::string out;
  out.reserve(in.size());
  for (size_t i = 0; i < in.size(); ++i) {
    if (in[i] == '%' && i + 2 < in.size()) {
      int h = hexval(in[i + 1]), l = hexval(in[i + 2]);
      if (h >= 0 && l >= 0) {
        out.push_back((char)(h * 16 + l));
        i += 2;
        continue;
      }
    }
    out.push_back(plus && in[i] == '+' ? ' ' : in[i]);
  }
  return out;
}

static void utf8_append(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    out->push_back((char)cp);
  } else if (cp < 0x800) {
    out->push_back((char)(0xC0 | (cp >> 6)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back((char)(0xE0 | (cp >> 12)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out->push_back((char)(0xF0 | (cp >> 18)));
    out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// Parse one JSON string starting at in[*i] (which must be '"'); advance *i
// past the closing quote.  Handles the escapes json.dumps emits, including
// \uXXXX surrogate pairs (tensor names are user input).
static bool json_string(const std::string& in, size_t* i, std::string* out) {
  out->clear();
  if (*i >= in.size() || in[*i] != '"') return false;
  ++*i;
  while (*i < in.size()) {
    char c = in[*i];
    if (c == '"') {
      ++*i;
      return true;
    }
    if (c == '\\') {
      if (*i + 1 >= in.size()) return false;
      char e = in[*i + 1];
      *i += 2;
      switch (e) {
        case '"': out->push_back('"'); break;
        case '\\': out->push_back('\\'); break;
        case '/': out->push_back('/'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'n': out->push_back('\n'); break;
        case 'r': out->push_back('\r'); break;
        case 't': out->push_back('\t'); break;
        case 'u': {
          if (*i + 4 > in.size()) return false;
          uint32_t cp = 0;
          for (int k = 0; k < 4; ++k) {
            int v = hexval(in[*i + k]);
            if (v < 0) return false;
            cp = cp * 16 + v;
          }
          *i += 4;
          if (cp >= 0xD800 && cp <= 0xDBFF && *i + 6 <= in.size() &&
              in[*i] == '\\' && in[*i + 1] == 'u') {
            uint32_t lo = 0;
            bool ok = true;
            for (int k = 0; k < 4; ++k) {
              int v = hexval(in[*i + 2 + k]);
              if (v < 0) { ok = false; break; }
              lo = lo * 16 + v;
            }
            if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              *i += 6;
            }
          }
          utf8_append(out, cp);
          break;
        }
        default: return false;
      }
      continue;
    }
    out->push_back(c);
    ++*i;
  }
  return false;
}

static void skip_ws(const std::string& in, size_t* i) {
  while (*i < in.size() && (in[*i] == ' ' || in[*i] == '\t' ||
                            in[*i] == '\n' || in[*i] == '\r'))
    ++*i;
}

// Parse a flat JSON object of string values: {"k": "v", ...}.
static bool json_strmap(const std::string& in,
                        std::vector<std::pair<std::string, std::string>>* out) {
  out->clear();
  size_t i = 0;
  skip_ws(in, &i);
  if (i >= in.size() || in[i] != '{') return false;
  ++i;
  skip_ws(in, &i);
  if (i < in.size() && in[i] == '}') return true;
  while (true) {
    std::string k, v;
    skip_ws(in, &i);
    if (!json_string(in, &i, &k)) return false;
    skip_ws(in, &i);
    if (i >= in.size() || in[i] != ':') return false;
    ++i;
    skip_ws(in, &i);
    if (!json_string(in, &i, &v)) return false;
    out->emplace_back(std::move(k), std::move(v));
    skip_ws(in, &i);
    if (i >= in.size()) return false;
    if (in[i] == ',') {
      ++i;
      continue;
    }
    if (in[i] == '}') return true;
    return false;
  }
}

// Decode the UTF-8 sequence at in[*i] into a code point and advance *i; an
// invalid or cut sequence reads as U+FFFD and advances one byte.
static uint32_t utf8_next(const std::string& in, size_t* i) {
  unsigned char c = in[*i];
  int n = c < 0x80 ? 0 : (c & 0xE0) == 0xC0 ? 1 : (c & 0xF0) == 0xE0 ? 2
        : (c & 0xF8) == 0xF0 ? 3 : -1;
  if (n < 0 || *i + n >= in.size()) {
    ++*i;
    return 0xFFFD;
  }
  uint32_t cp = n == 0 ? c : c & (0x3F >> n);
  for (int k = 1; k <= n; ++k) {
    unsigned char cc = in[*i + k];
    if ((cc & 0xC0) != 0x80) {
      ++*i;
      return 0xFFFD;
    }
    cp = (cp << 6) | (cc & 0x3F);
  }
  *i += n + 1;
  return cp;
}

// Serialize a JSON string as json.dumps does (ensure_ascii): printable
// ASCII passes through, the structural escapes stay short, and every other
// character is \uXXXX (lowercase hex; a surrogate pair above the BMP).
static void json_escape(const std::string& in, std::string* out) {
  out->push_back('"');
  char buf[16];
  for (size_t i = 0; i < in.size();) {
    unsigned char c = in[i];
    if (c >= 0x20 && c < 0x7F && c != '"' && c != '\\') {
      out->push_back((char)c);
      ++i;
      continue;
    }
    switch (c) {
      case '"': *out += "\\\""; ++i; continue;
      case '\\': *out += "\\\\"; ++i; continue;
      case '\b': *out += "\\b"; ++i; continue;
      case '\f': *out += "\\f"; ++i; continue;
      case '\n': *out += "\\n"; ++i; continue;
      case '\r': *out += "\\r"; ++i; continue;
      case '\t': *out += "\\t"; ++i; continue;
      default: break;
    }
    uint32_t cp = utf8_next(in, &i);
    if (cp >= 0x10000) {
      cp -= 0x10000;
      snprintf(buf, sizeof(buf), "\\u%04x\\u%04x", 0xD800 + (cp >> 10),
               0xDC00 + (cp & 0x3FF));
    } else {
      snprintf(buf, sizeof(buf), "\\u%04x", cp);
    }
    *out += buf;
  }
  out->push_back('"');
}

// ---------------------------------------------------------------------------
// Store: scoped KV + per-scope conditions (mirrors _KVHandler's model)
// ---------------------------------------------------------------------------

// A stored value: shared and immutable, so a GET or a scan takes a
// reference under the store lock and sends outside it, copying nothing.
using Value = std::shared_ptr<const std::string>;
using Item = std::pair<std::string, Value>;

static Value make_value(std::string bytes) {
  return std::make_shared<const std::string>(std::move(bytes));
}

// One scope: keys in insertion order (a put of a present key keeps its
// place), as a Python dict keeps them.
class Scope {
 public:
  Scope() = default;
  Scope(const Scope&) = delete;
  Scope& operator=(const Scope&) = delete;

  void put(const std::string& key, Value value) {
    auto it = index_.find(key);
    if (it != index_.end()) {
      it->second->second = std::move(value);
      return;
    }
    items_.emplace_back(key, std::move(value));
    index_.emplace(key, std::prev(items_.end()));
  }

  Value find(const std::string& key) const {
    auto it = index_.find(key);
    return it == index_.end() ? nullptr : it->second->second;
  }

  void erase(const std::string& key) {
    auto it = index_.find(key);
    if (it == index_.end()) return;
    items_.erase(it->second);
    index_.erase(it);
  }

  size_t size() const { return items_.size(); }
  bool empty() const { return items_.empty(); }
  const std::list<Item>& items() const { return items_; }

 private:
  std::list<Item> items_;
  std::unordered_map<std::string, std::list<Item>::iterator> index_;
};

// The scan body: {key: base64(value)} as json.dumps writes it.
static std::string scan_json(const std::vector<Item>& snapshot) {
  std::string body = "{";
  bool first = true;
  for (auto& kv : snapshot) {
    if (!first) body += ", ";
    first = false;
    json_escape(kv.first, &body);
    body += ": ";
    json_escape(b64encode(*kv.second), &body);
  }
  body += "}";
  return body;
}

struct Server {
  std::mutex m;
  std::map<std::string, Scope> data;
  // shared_ptr so a scope delete can retire a condition while waiters still
  // hold it; they wake, re-check, and re-fetch a fresh one next iteration.
  std::map<std::string, std::shared_ptr<std::condition_variable>> conds;
  std::atomic<bool> stopping{false};
  int listen_fd = -1;
  int port = 0;
  std::set<int> client_fds;  // guarded by m
  int active_conns = 0;      // guarded by m: connection threads alive
  std::condition_variable conns_done;
  std::thread accept_thread;

  std::shared_ptr<std::condition_variable> cond(const std::string& scope) {
    auto it = conds.find(scope);
    if (it != conds.end()) return it->second;
    auto c = std::make_shared<std::condition_variable>();
    conds[scope] = c;
    return c;
  }

  void notify(const std::string& scope) {
    auto it = conds.find(scope);
    if (it != conds.end()) it->second->notify_all();
  }

  void gc_cond(const std::string& scope) {
    auto it = conds.find(scope);
    if (it != conds.end()) {
      it->second->notify_all();
      conds.erase(it);
    }
  }

  void wake_all() {
    std::lock_guard<std::mutex> g(m);
    for (auto& kv : conds) kv.second->notify_all();
  }

  Value find(const std::string& scope, const std::string& key) {
    auto sit = data.find(scope);
    return sit == data.end() ? nullptr : sit->second.find(key);
  }

  std::vector<Item> snapshot(const std::string& scope) {
    auto sit = data.find(scope);
    if (sit == data.end()) return {};
    const auto& items = sit->second.items();
    return std::vector<Item>(items.begin(), items.end());
  }
};

// ---------------------------------------------------------------------------
// HTTP plumbing
// ---------------------------------------------------------------------------

// Framing caps: a header block or declared body beyond these answers 400
// and drops the connection instead of buffering without bound (a garbage or
// hostile peer could otherwise OOM the one launcher host the control plane
// runs on).  Control-plane payloads are small; result gathers, batch puts
// and the serving fleet's KV-tier blocks (~1.2 MB) stay far under the body
// cap.
static const size_t kMaxHeaderBytes = size_t(1) << 20;   // 1 MiB
static const size_t kMaxBodyBytes = size_t(1) << 30;     // 1 GiB

struct Conn {
  int fd;
  std::string buf;   // unconsumed bytes
  bool ok = true;
  bool oversize = false;  // framing cap exceeded: answer 400, then close

  explicit Conn(int f) : fd(f) {}

  // Read until the buffer contains `delim`; returns position or npos.
  // Stops (oversize) once more than `cap` bytes accumulate without the
  // delimiter appearing.
  size_t read_until(const std::string& delim, size_t cap) {
    while (true) {
      size_t pos = buf.find(delim);
      if (pos != std::string::npos) {
        if (pos > cap) {
          oversize = true;
          return std::string::npos;
        }
        return pos;
      }
      if (buf.size() > cap + delim.size()) {
        oversize = true;
        return std::string::npos;
      }
      char tmp[8192];
      ssize_t n = recv(fd, tmp, sizeof(tmp), 0);
      if (n <= 0) {
        ok = false;
        return std::string::npos;
      }
      buf.append(tmp, n);
    }
  }

  bool read_n(size_t n, std::string* out, size_t cap) {
    if (n > cap) {
      oversize = true;
      return false;
    }
    if (buf.size() < n) buf.reserve(n);
    while (buf.size() < n) {
      char tmp[65536];
      ssize_t r = recv(fd, tmp, sizeof(tmp), 0);
      if (r <= 0) {
        ok = false;
        return false;
      }
      buf.append(tmp, r);
    }
    if (buf.size() == n) {
      out->swap(buf);  // the usual case: the body ends the buffer
      buf.clear();
    } else {
      out->assign(buf, 0, n);
      buf.erase(0, n);
    }
    return true;
  }

  // Send head then body as one gather write (no copy of the body into
  // the head's buffer; a fleet-tier block is ~1.2 MB).
  void write_all(const std::string& head, const std::string& body) {
    size_t off = 0, total = head.size() + body.size();
    while (off < total) {
      iovec iov[2];
      int n_iov = 0;
      if (off < head.size()) {
        iov[n_iov++] = {(void*)(head.data() + off), head.size() - off};
        iov[n_iov++] = {(void*)body.data(), body.size()};
      } else {
        iov[n_iov++] = {(void*)(body.data() + off - head.size()),
                        total - off};
      }
      msghdr msg{};
      msg.msg_iov = iov;
      msg.msg_iovlen = n_iov;
      ssize_t n = sendmsg(fd, &msg, MSG_NOSIGNAL);
      if (n <= 0) {
        ok = false;
        return;
      }
      off += n;
    }
  }
};

struct Request {
  std::string method;
  std::string scope;          // decoded first path segment
  std::string key;            // decoded remaining segments joined with '/'
  std::map<std::string, std::string> query;
  std::string body;
};

static bool parse_request(Conn* c, Request* rq) {
  size_t hdr_end = c->read_until("\r\n\r\n", kMaxHeaderBytes);
  if (hdr_end == std::string::npos) return false;
  std::string head = c->buf.substr(0, hdr_end);
  c->buf.erase(0, hdr_end + 4);
  size_t line_end = head.find("\r\n");
  std::string reqline =
      line_end == std::string::npos ? head : head.substr(0, line_end);
  size_t sp1 = reqline.find(' ');
  size_t sp2 = reqline.rfind(' ');
  if (sp1 == std::string::npos || sp2 == sp1) return false;
  rq->method = reqline.substr(0, sp1);
  std::string target = reqline.substr(sp1 + 1, sp2 - sp1 - 1);
  // Content-Length (case-insensitive scan of the header block); every
  // other header (the client's X-Trace-Id / X-Parent-Span) is skipped.
  size_t clen = 0;
  size_t pos = line_end;
  while (pos != std::string::npos && pos < head.size()) {
    size_t next = head.find("\r\n", pos + 2);
    std::string line = head.substr(
        pos + 2, next == std::string::npos ? std::string::npos
                                           : next - pos - 2);
    if (line.size() > 15) {
      std::string lower;
      for (char ch : line.substr(0, 15)) lower += (char)tolower(ch);
      if (lower == "content-length:")
        clen = strtoull(line.c_str() + 15, nullptr, 10);
    }
    pos = next;
  }
  // Split query, decode path segments.
  std::string path = target, qs;
  size_t qpos = target.find('?');
  if (qpos != std::string::npos) {
    path = target.substr(0, qpos);
    qs = target.substr(qpos + 1);
  }
  size_t start = path.find_first_not_of('/');
  std::vector<std::string> segs;
  if (start != std::string::npos) {
    std::string trimmed = path.substr(start);
    while (!trimmed.empty() && trimmed.back() == '/') trimmed.pop_back();
    size_t p = 0;
    while (true) {
      size_t slash = trimmed.find('/', p);
      segs.push_back(pct_decode(trimmed.substr(
          p, slash == std::string::npos ? std::string::npos : slash - p)));
      if (slash == std::string::npos) break;
      p = slash + 1;
    }
  }
  rq->scope = segs.empty() ? "" : segs[0];
  rq->key.clear();
  for (size_t i = 1; i < segs.size(); ++i) {
    if (i > 1) rq->key += '/';
    rq->key += segs[i];
  }
  rq->query.clear();
  size_t p = 0;
  while (p < qs.size()) {
    size_t amp = qs.find('&', p);
    std::string pair = qs.substr(
        p, amp == std::string::npos ? std::string::npos : amp - p);
    size_t eq = pair.find('=');
    if (eq != std::string::npos)
      rq->query[pct_decode(pair.substr(0, eq), true)] =
          pct_decode(pair.substr(eq + 1), true);
    if (amp == std::string::npos) break;
    p = amp + 1;
  }
  if (clen > 0) {
    if (!c->read_n(clen, &rq->body, kMaxBodyBytes)) return false;
  } else {
    rq->body.clear();
  }
  return true;
}

static void respond(Conn* c, int code, const std::string& body) {
  const char* text = code == 200   ? "OK"
                     : code == 404 ? "Not Found"
                                   : "Bad Request";
  std::string head = "HTTP/1.1 " + std::to_string(code) + " " + text +
                     "\r\nContent-Length: " + std::to_string(body.size()) +
                     "\r\n\r\n";
  c->write_all(head, body);
}

static double query_double(const Request& rq, const char* name, double cap) {
  auto it = rq.query.find(name);
  if (it == rq.query.end()) return 0.0;
  char* end = nullptr;
  double v = strtod(it->second.c_str(), &end);
  if (end == it->second.c_str()) return 0.0;
  return v < cap ? v : cap;
}

// ---------------------------------------------------------------------------
// Endpoint handlers (parity with _KVHandler, runner/http_server.py)
// ---------------------------------------------------------------------------

using Clock = std::chrono::steady_clock;

static Clock::time_point deadline_after(double wait_s) {
  return Clock::now() + std::chrono::duration_cast<Clock::duration>(
                            std::chrono::duration<double>(wait_s));
}

static void handle_put(Server* s, Conn* c, Request& rq) {
  Value v = make_value(std::move(rq.body));
  {
    std::lock_guard<std::mutex> g(s->m);
    s->data[rq.scope].put(rq.key, std::move(v));
    s->notify(rq.scope);
  }
  respond(c, 200, "");
}

static void handle_batch_put(Server* s, Conn* c, const Request& rq) {
  std::vector<std::pair<std::string, std::string>> items;
  if (!json_strmap(rq.body.empty() ? std::string("{}") : rq.body, &items)) {
    respond(c, 400, "");
    return;
  }
  std::vector<Item> decoded;
  decoded.reserve(items.size());
  for (auto& kv : items) {
    std::string raw;
    if (!b64decode(kv.second, &raw)) {
      respond(c, 400, "");
      return;
    }
    decoded.emplace_back(std::move(kv.first), make_value(std::move(raw)));
  }
  {
    std::lock_guard<std::mutex> g(s->m);
    auto& scope = s->data[rq.scope];
    for (auto& kv : decoded) scope.put(kv.first, std::move(kv.second));
    s->notify(rq.scope);
  }
  respond(c, 200, "");
}

static void handle_put_wait(Server* s, Conn* c, Request& rq) {
  auto as = rq.query.find("ascope");
  auto ak = rq.query.find("akey");
  if (as == rq.query.end() || ak == rq.query.end()) {
    respond(c, 400, "");
    return;
  }
  double wait_s = query_double(rq, "wait", 60.0);
  Value v = make_value(std::move(rq.body)), out;
  {
    std::unique_lock<std::mutex> g(s->m);
    s->data[rq.scope].put(rq.key, std::move(v));
    s->notify(rq.scope);
    auto deadline = deadline_after(wait_s);
    while (!s->stopping) {
      if ((out = s->find(as->second, ak->second))) break;
      if (Clock::now() >= deadline) break;
      s->cond(as->second)->wait_until(g, deadline);
    }
  }
  if (!out)
    respond(c, 404, "");
  else
    respond(c, 200, *out);
}

static void handle_get(Server* s, Conn* c, const Request& rq) {
  double wait_s = query_double(rq, "wait", 60.0);
  Value out;
  {
    std::unique_lock<std::mutex> g(s->m);
    auto deadline = deadline_after(wait_s);
    while (true) {
      if ((out = s->find(rq.scope, rq.key))) break;
      if (wait_s <= 0 || s->stopping) break;
      if (Clock::now() >= deadline) break;
      s->cond(rq.scope)->wait_until(g, deadline);
    }
  }
  if (!out)
    respond(c, 404, "");
  else
    respond(c, 200, *out);
}

static void handle_scan(Server* s, Conn* c, const Request& rq) {
  double wait_s = query_double(rq, "wait", 60.0);
  long min_keys = 0;
  auto it = rq.query.find("min");
  if (it != rq.query.end()) min_keys = strtol(it->second.c_str(), nullptr, 10);
  std::vector<Item> snapshot;
  {
    std::unique_lock<std::mutex> g(s->m);
    auto deadline = deadline_after(wait_s);
    while (true) {
      auto sit = s->data.find(rq.scope);
      size_t n = sit == s->data.end() ? 0 : sit->second.size();
      if (min_keys <= 0 || (long)n >= min_keys || wait_s <= 0 ||
          s->stopping || Clock::now() >= deadline) {
        snapshot = s->snapshot(rq.scope);
        break;
      }
      s->cond(rq.scope)->wait_until(g, deadline);
    }
  }
  respond(c, 200, scan_json(snapshot));
}

static void handle_delete(Server* s, Conn* c, const Request& rq) {
  {
    std::lock_guard<std::mutex> g(s->m);
    if (rq.key.empty()) {
      s->data.erase(rq.scope);
      s->gc_cond(rq.scope);
    } else {
      auto sit = s->data.find(rq.scope);
      if (sit != s->data.end()) {
        sit->second.erase(rq.key);
        if (sit->second.empty()) {
          s->data.erase(sit);
          s->gc_cond(rq.scope);
        }
      }
    }
  }
  respond(c, 200, "");
}

static void serve_conn(std::shared_ptr<Server> s, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  Conn c(fd);
  Request rq;
  while (!s->stopping && c.ok) {
    if (!parse_request(&c, &rq)) {
      // An over-cap header/body gets an explicit 400 before the close;
      // the stream position is unrecoverable, so the connection ends
      // either way.  Plain EOF/reset just closes.
      if (c.oversize && c.ok) respond(&c, 400, "");
      break;
    }
    if (rq.method == "PUT") {
      handle_put(s.get(), &c, rq);
    } else if (rq.method == "POST") {
      if (!rq.key.empty())
        handle_put_wait(s.get(), &c, rq);
      else
        handle_batch_put(s.get(), &c, rq);
    } else if (rq.method == "GET") {
      if (rq.key.empty())
        handle_scan(s.get(), &c, rq);
      else
        handle_get(s.get(), &c, rq);
    } else if (rq.method == "DELETE") {
      handle_delete(s.get(), &c, rq);
    } else {
      respond(&c, 400, "");
    }
  }
  std::lock_guard<std::mutex> g(s->m);
  s->client_fds.erase(fd);
  close(fd);
  --s->active_conns;
  s->conns_done.notify_all();
}

static void accept_loop(std::shared_ptr<Server> s) {
  while (!s->stopping) {
    int fd = accept4(s->listen_fd, nullptr, nullptr, SOCK_CLOEXEC);
    if (fd < 0) {
      if (s->stopping) break;
      if (errno == EINTR) continue;
      // Persistent accept errors (EMFILE under fd pressure) must not
      // busy-spin the one launcher core the control plane depends on.
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
      continue;
    }
    {
      std::lock_guard<std::mutex> g(s->m);
      if (s->stopping) {
        close(fd);
        break;
      }
      s->client_fds.insert(fd);
      ++s->active_conns;
    }
    std::thread(serve_conn, s, fd).detach();
  }
}

// ---------------------------------------------------------------------------
// Registry + fork handlers + C ABI
// ---------------------------------------------------------------------------

static std::mutex g_reg_mutex;
static std::map<int64_t, std::shared_ptr<Server>> g_registry;
static int64_t g_next_id = 1;

static std::shared_ptr<Server> lookup(void* h) {
  std::lock_guard<std::mutex> g(g_reg_mutex);
  auto it = g_registry.find((int64_t)(intptr_t)h);
  return it == g_registry.end() ? nullptr : it->second;
}

// fork() copies only the forking thread.  The prepare handler takes every
// lock a server thread may hold, so the child starts with none held by a
// thread it does not have; the child then stops serving in its copy (the
// parent keeps the port) while its store stays readable in process.
static void atfork_prepare() {
  g_reg_mutex.lock();
  for (auto& kv : g_registry) kv.second->m.lock();
}

static void atfork_parent() {
  for (auto& kv : g_registry) kv.second->m.unlock();
  g_reg_mutex.unlock();
}

static void atfork_child() {
  for (auto& kv : g_registry) {
    Server* s = kv.second.get();
    s->stopping = true;
    if (s->listen_fd >= 0) close(s->listen_fd);
    s->listen_fd = -1;
    for (int fd : s->client_fds) close(fd);
    s->client_fds.clear();
    s->active_conns = 0;
    // The accept thread does not exist here: forget it, or the copy's
    // std::thread destructor would terminate the child.
    if (s->accept_thread.joinable())
      new (&s->accept_thread) std::thread();
    s->m.unlock();
  }
  g_reg_mutex.unlock();
}

static std::once_flag g_atfork_once;

}  // namespace hvdkv

extern "C" {

// Start a server on `port` (0 = ephemeral).  Returns an opaque handle
// (nullptr on failure); *actual_port receives the bound port.
void* hvd_kv_start(int port, int* actual_port) {
  using namespace hvdkv;
  std::call_once(g_atfork_once, [] {
    pthread_atfork(atfork_prepare, atfork_parent, atfork_child);
  });
  auto s = std::make_shared<Server>();
  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (s->listen_fd < 0) return nullptr;
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons((uint16_t)port);
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
      listen(s->listen_fd, 128) < 0) {
    close(s->listen_fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);
  if (actual_port) *actual_port = s->port;
  std::lock_guard<std::mutex> g(g_reg_mutex);
  s->accept_thread = std::thread(accept_loop, s);
  int64_t id = g_next_id++;
  g_registry[id] = s;
  return (void*)(intptr_t)id;
}

// Stop serving: close the listener, wake every long-poll waiter, shut down
// client sockets, and wait (up to 10 s) until every connection thread has
// left.  The STORE stays readable through the in-process API
// (hvd_kv_get/hvd_kv_scan_json) until hvd_kv_destroy — launcher code reads
// gathered results after shutdown (runner/__init__.py result gather).
// Returns the connection threads still alive (0 after a clean stop).
int hvd_kv_stop(void* h) {
  using namespace hvdkv;
  auto s = lookup(h);
  if (!s) return 0;
  if (s->stopping.exchange(true)) return 0;  // idempotent: destroy()
  // re-calls, and a recycled fd number must never be shut down twice
  shutdown(s->listen_fd, SHUT_RDWR);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  close(s->listen_fd);
  s->listen_fd = -1;
  s->wake_all();
  std::unique_lock<std::mutex> g(s->m);
  for (int fd : s->client_fds) shutdown(fd, SHUT_RDWR);
  s->conns_done.wait_for(g, std::chrono::seconds(10),
                         [&] { return s->active_conns == 0; });
  return s->active_conns;
}

void hvd_kv_destroy(void* h) {
  using namespace hvdkv;
  hvd_kv_stop(h);
  std::lock_guard<std::mutex> g(g_reg_mutex);
  g_registry.erase((int64_t)(intptr_t)h);
}

int hvd_kv_port(void* h) {
  auto s = hvdkv::lookup(h);
  return s ? s->port : -1;
}

void hvd_kv_put(void* h, const char* scope, const char* key,
                const uint8_t* value, int64_t len) {
  auto s = hvdkv::lookup(h);
  if (!s) return;
  using namespace hvdkv;
  Value v = make_value(std::string((const char*)value, (size_t)len));
  std::lock_guard<std::mutex> g(s->m);
  s->data[scope].put(key, std::move(v));
  s->notify(scope);
}

// Returns a malloc'd copy (caller frees with hvd_kv_free); nullptr if absent.
uint8_t* hvd_kv_get(void* h, const char* scope, const char* key,
                    int64_t* len) {
  auto s = hvdkv::lookup(h);
  *len = -1;
  if (!s) return nullptr;
  hvdkv::Value v;
  {
    std::lock_guard<std::mutex> g(s->m);
    v = s->find(scope, key);
  }
  if (!v) return nullptr;
  // malloc(0) may return nullptr, which the caller reads as "absent":
  // always allocate at least one byte so an empty value round-trips as b"".
  uint8_t* out = (uint8_t*)malloc(v->size() + 1);
  if (!out) return nullptr;  // allocation failure reads as "absent"
  // (*len stays -1), never a memcpy through nullptr
  memcpy(out, v->data(), v->size());
  *len = (int64_t)v->size();
  return out;
}

// Whole-scope snapshot as the same JSON {key: base64(value)} body the HTTP
// scan returns (caller frees with hvd_kv_free).
char* hvd_kv_scan_json(void* h, const char* scope) {
  using namespace hvdkv;
  auto s = lookup(h);
  if (!s) return nullptr;
  std::vector<Item> snapshot;
  {
    std::lock_guard<std::mutex> g(s->m);
    snapshot = s->snapshot(scope);
  }
  std::string body = scan_json(snapshot);
  char* out = (char*)malloc(body.size() + 1);
  if (!out) return nullptr;
  memcpy(out, body.c_str(), body.size() + 1);
  return out;
}

void hvd_kv_free(void* p) { free(p); }

}  // extern "C"
