// emul_engine: native host simulator core for the `emul_native` backend.
//
// A fresh C++ implementation of the membership protocol + in-memory network
// with the same tick semantics as the Python `emul` backend (the executable
// spec, backends/emul.py) and the reference it mirrors:
//   * two-pass synchronous tick: receives ascending, protocol descending
//     (Application::mp1Run, Application.cpp:121-164);
//   * bounded global message buffer, newest-first intra-tick delivery
//     (EmulNet::ENrecv's top-down swap-remove scan, EmulNet.cpp:144-177);
//   * JOINREQ/JOINREP handshake via the introducer, full-list gossip to
//     FANOUT random targets, TFAIL/TREMOVE sweep, stale-entry withholding
//     (MP1Node.cpp:73-495).
//
// Deliberately NOT a translation of the reference's design:
//   * members are (id, heartbeat, timestamp) in a sorted std::vector per
//     node — integer keys end-to-end (no strcmp on binary addresses:
//     reference defect D5, EmulNet.cpp:154, is structurally impossible);
//   * messages are 24-byte PODs in one reusable buffer — no per-message
//     malloc/free, so the reference's leak-per-message (D4,
//     EmulNet.cpp:156) has no analog;
//   * protocol events (join/remove) stream into a caller-provided buffer;
//     the log-format contract stays in one place (Python's EventLog);
//   * all randomness derives from one caller-provided seed via
//     std::mt19937_64 — runs are reproducible, unlike the reference's
//     random_device-seeded gossip (MP1Node.cpp:450).
//
// Build: g++ -O2 -shared -fPIC (driven by backends/emul_native.py).

#include <algorithm>
#include <cstdint>
#include <random>
#include <vector>

namespace {

struct Msg {
  int32_t src;
  int32_t dst;
  int32_t kind;  // 0 JOINREQ, 1 JOINREP, 2 LIST
  int32_t id;    // payload member id (JOINREQ/LIST)
  int64_t hb;    // payload heartbeat
};

constexpr int32_t KIND_JOINREQ = 0;
constexpr int32_t KIND_JOINREP = 1;
constexpr int32_t KIND_LIST = 2;

// Wire sizes, for buffer accounting parity with the reference
// (MP1Node.cpp:143,247,364; EmulNet.h:23-30).
constexpr int64_t LIST_MSG_SIZE = 19;
constexpr int64_t JOINREQ_MSG_SIZE = 19;
constexpr int64_t JOINREP_MSG_SIZE = 4;
constexpr int64_t EN_MSG_HDR = 16;

struct Entry {
  int32_t id;
  int64_t hb;
  int32_t ts;
};

struct Node {
  int32_t id = 0;  // 1-based (ENinit assigns 1..N, EmulNet.cpp:74)
  bool failed = false;
  bool in_group = false;
  bool started = false;
  int64_t hb = 0;
  std::vector<Entry> members;   // sorted by id
  std::vector<Msg> inbox;       // drained every tick
};

struct Event {
  int32_t kind;     // 0 joined, 1 removed
  int32_t logger;   // 1-based node id doing the logging
  int32_t subject;  // 1-based node id joined/removed
  int32_t tick;
};

struct Sim {
  // config
  int32_t n, total_time, tfail, tremove, fanout;
  int32_t fail_time, drop_start, drop_stop, drop_pct;
  int64_t en_buffsize, max_msg_size;
  int32_t join_mode;   // 0 staggered, 1 batch
  double step_rate;
  // state
  std::vector<Node> nodes;
  std::vector<Msg> net;         // the global bounded buffer
  bool dropmsg = false;
  std::mt19937_64 rng_net, rng_gossip;
  // outputs
  int32_t* sent;                // [n, total_time]
  int32_t* recv;
  Event* events;
  int64_t events_cap, n_events = 0, overflowed = 0;

  int start_tick(int i) const {
    return join_mode == 1 ? 0 : static_cast<int>(step_rate * i);
  }

  void emit(int32_t kind, int32_t logger, int32_t subject, int32_t tick) {
    if (n_events >= events_cap) { overflowed = 1; return; }
    events[n_events++] = Event{kind, logger, subject, tick};
  }

  // ENsend (EmulNet.cpp:87-118): drop on full buffer / oversize / Bernoulli
  // inside the drop window; count only accepted sends.
  void send(int32_t src, int32_t dst, int32_t kind, int32_t id, int64_t hb,
            int64_t size, int t) {
    if (static_cast<int64_t>(net.size()) >= en_buffsize) return;
    if (size + EN_MSG_HDR >= max_msg_size) return;
    if (dropmsg &&
        static_cast<int32_t>(rng_net() % 100) < drop_pct) return;
    net.push_back(Msg{src, dst, kind, id, hb});
    sent[(src - 1) * total_time + t] += 1;
  }

  // ENrecv semantics: scan top-down, swap-remove → newest-first delivery.
  void recv_all(Node& node, int t) {
    for (int64_t i = static_cast<int64_t>(net.size()) - 1; i >= 0; --i) {
      if (net[i].dst == node.id) {
        node.inbox.push_back(net[i]);
        net[i] = net.back();
        net.pop_back();
        recv[(node.id - 1) * total_time + t] += 1;
      }
    }
  }

  // updatelistCallBack (MP1Node.cpp:259-301): strict-increase merge,
  // sorted insert + join event for unknown ids.
  bool update_list(Node& node, int32_t eid, int64_t ehb, int t) {
    auto it = std::lower_bound(
        node.members.begin(), node.members.end(), eid,
        [](const Entry& e, int32_t key) { return e.id < key; });
    if (it != node.members.end() && it->id == eid) {
      if (it->hb < ehb) {
        it->hb = ehb;
        it->ts = t;
      }
      return false;
    }
    node.members.insert(it, Entry{eid, ehb, t});
    emit(0, node.id, eid, t);
    return true;
  }

  void node_start(Node& node, int t) {
    node.started = true;
    node.failed = false;
    node.in_group = false;
    node.hb = 0;
    node.members.clear();
    if (node.id == 1) {  // the introducer (getjoinaddr, Application.cpp:209)
      update_my_pos(node, t);
      node.in_group = true;
    } else {
      send(node.id, 1, KIND_JOINREQ, node.id, node.hb, JOINREQ_MSG_SIZE, t);
    }
  }

  // updateMyPos with the D3 fix: a plain insert-if-absent.
  size_t update_my_pos(Node& node, int t) {
    auto it = std::lower_bound(
        node.members.begin(), node.members.end(), node.id,
        [](const Entry& e, int32_t key) { return e.id < key; });
    if (it == node.members.end() || it->id != node.id)
      it = node.members.insert(it, Entry{node.id, node.hb, t});
    return static_cast<size_t>(it - node.members.begin());
  }

  void node_loop(Node& node, int t) {
    // drain inbox (checkMessages, MP1Node.cpp:208-223)
    std::vector<int32_t> new_nodes;
    for (const Msg& m : node.inbox) {
      switch (m.kind) {
        case KIND_JOINREQ:
          if (update_list(node, m.id, m.hb, t)) new_nodes.push_back(m.id);
          send(node.id, m.id, KIND_JOINREP, 0, 0, JOINREP_MSG_SIZE, t);
          break;
        case KIND_JOINREP:
          node.in_group = true;
          break;
        case KIND_LIST:
          update_list(node, m.id, m.hb, t);
          break;
      }
    }
    node.inbox.clear();
    if (!node.in_group) return;

    // nodeLoopOps (MP1Node.cpp:404-495)
    size_t mypos = update_my_pos(node, t);
    node.hb += 1;  // double increment: own entry holds the odd
    node.members[mypos].hb = node.hb;  // intermediate (MP1Node.cpp:412-414)
    node.hb += 1;
    node.members[mypos].ts = t;

    // TFAIL/TREMOVE sweep: one in-place filtering pass (order-preserving,
    // equivalent to the reference's swap-remove + re-sort).
    int32_t numfailed = 0;
    size_t w = 0;
    for (size_t r = 0; r < node.members.size(); ++r) {
      const Entry& e = node.members[r];
      int difft = t - e.ts;
      if (difft >= tfail) {
        ++numfailed;
        if (difft >= tremove) {
          emit(1, node.id, e.id, t);
          continue;
        }
      }
      node.members[w++] = e;
    }
    node.members.resize(w);

    // gossip targets: this tick's joiners guaranteed, then rejection-sample
    // distinct fresh non-self entries up to the potential bound
    // (MP1Node.cpp:449-489).
    std::vector<int32_t> gossip = new_nodes;
    int64_t numpotential =
        static_cast<int64_t>(node.members.size()) - 1 - numfailed;
    while (static_cast<int64_t>(gossip.size()) < fanout &&
           static_cast<int64_t>(gossip.size()) < numpotential) {
      const Entry& e =
          node.members[rng_gossip() % node.members.size()];
      if (e.id == node.id) continue;
      if (t - e.ts >= tfail) continue;
      if (std::find(gossip.begin(), gossip.end(), e.id) != gossip.end())
        continue;
      gossip.push_back(e.id);
    }

    // sendMemberList: one LIST per fresh entry per target (MP1Node.cpp:360-395).
    for (int32_t target : gossip) {
      for (const Entry& e : node.members) {
        if (t - e.ts >= tfail) continue;
        send(node.id, target, KIND_LIST, e.id, e.hb, LIST_MSG_SIZE, t);
      }
    }
  }
};

}  // namespace

extern "C" {

struct DmConfig {
  int32_t n, total_time, tfail, tremove, fanout;
  int32_t fail_time, drop_start, drop_stop, drop_pct;
  int64_t en_buffsize, max_msg_size;
  int32_t join_mode;
  double step_rate;
  uint64_t seed;
};

// Runs the full simulation.  fail_mask: [n] bytes (1 = crash at fail_time).
// sent/recv: [n * total_time] int32, zeroed by caller.  events:
// [events_cap] records of 4 x int32.  Returns 0 on success, 1 if the event
// buffer overflowed (results truncated).
int dm_run(const DmConfig* cfg, const uint8_t* fail_mask, int32_t* sent,
           int32_t* recv, int32_t* events, int64_t events_cap,
           int64_t* n_events_out) {
  Sim sim;
  sim.n = cfg->n;
  sim.total_time = cfg->total_time;
  sim.tfail = cfg->tfail;
  sim.tremove = cfg->tremove;
  sim.fanout = cfg->fanout;
  sim.fail_time = cfg->fail_time;
  sim.drop_start = cfg->drop_start;
  sim.drop_stop = cfg->drop_stop;
  sim.drop_pct = cfg->drop_pct;
  sim.en_buffsize = cfg->en_buffsize;
  sim.max_msg_size = cfg->max_msg_size;
  sim.join_mode = cfg->join_mode;
  sim.step_rate = cfg->step_rate;
  sim.sent = sent;
  sim.recv = recv;
  sim.events = reinterpret_cast<Event*>(events);
  sim.events_cap = events_cap;
  sim.rng_net.seed(cfg->seed * 0x9E3779B97F4A7C15ULL + 1);
  sim.rng_gossip.seed(cfg->seed * 0xC2B2AE3D27D4EB4FULL + 2);

  sim.nodes.resize(sim.n);
  for (int i = 0; i < sim.n; ++i) sim.nodes[i].id = i + 1;
  sim.net.reserve(static_cast<size_t>(sim.en_buffsize));

  for (int t = 0; t < sim.total_time; ++t) {
    // pass 1: receive, ascending (Application.cpp:125-135)
    for (int i = 0; i < sim.n; ++i) {
      Node& node = sim.nodes[i];
      if (t > sim.start_tick(i) && node.started && !node.failed)
        sim.recv_all(node, t);
    }
    // pass 2: start / act, descending (Application.cpp:138-163)
    for (int i = sim.n - 1; i >= 0; --i) {
      Node& node = sim.nodes[i];
      if (t == sim.start_tick(i)) {
        sim.node_start(node, t);
      } else if (t > sim.start_tick(i) && node.started && !node.failed) {
        sim.node_loop(node, t);
      }
    }
    // failure + drop-window injection, end of tick (Application::fail)
    if (sim.drop_start >= 0 && t == sim.drop_start) sim.dropmsg = true;
    if (t == sim.fail_time) {
      for (int i = 0; i < sim.n; ++i)
        if (fail_mask[i]) sim.nodes[i].failed = true;
    }
    if (sim.drop_stop >= 0 && t == sim.drop_stop) sim.dropmsg = false;
  }

  *n_events_out = sim.n_events;
  return sim.overflowed ? 1 : 0;
}

}  // extern "C"
