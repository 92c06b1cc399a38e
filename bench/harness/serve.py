"""Drive the port's serving engine with a mix and record what users see.

The engine is ``repro_torch.serving.engine.ServingEngine``; it gets only
the generated requests, through ``submit`` and ``step``.  The harness
puts its own host clock beside the engine's step counts:

- every step's return is stamped; a token is visible at the return of
  the step that emitted it (``step`` ends in a device-to-host copy, so
  the stamp follows the device's work);
- interactive (IW) requests are open loop: each is due at a time drawn
  from the mix's arrival process, is submitted at the first step start
  at or after it, and is timed from when it was due;
- the batch (NIW) backlog is closed loop: before every step the queue
  is topped up to the mix's ``depth``.

Deadlines are the engine's convention, in engine steps after the step
of arrival (``deadline_steps``), so that DPA can order by them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench.harness import traffic


@dataclasses.dataclass
class Tracked:
    """One request as the harness sees it."""

    req: object                  # the engine's ServeRequest
    kind: str                    # "fill", "iw" or "niw"
    due: float                   # host clock: due (IW) or submitted
    submitted: float = math.nan  # host clock of the submit
    times: List[float] = dataclasses.field(default_factory=list)
    admit_start: float = math.nan   # start of the step that admitted it

    @property
    def ttft(self) -> float:
        return self.times[0] - self.due if self.times else math.inf


@dataclasses.dataclass
class StepRec:
    """One engine step: its host-clock span, the prompt lengths it
    admitted, and the position each request decoded at."""

    start: float
    end: float
    prompts: List[int]
    contexts: List[int]


class Clients:
    """Feeds one cell's traffic to the engine, step by step, and stamps
    every token a step makes visible."""

    def __init__(self, engine, mix: Dict, seed: int, vocab: int,
                 request_cls, clock: Callable[[], float] = time.perf_counter):
        self.engine, self.mix, self.clock = engine, mix, clock
        self.request_cls = request_cls
        self.niw = traffic.Stream(mix, seed, vocab, 0,
                                   ["NIW"] * traffic.BLOCK)
        iw = mix.get("iw")
        self.iw = traffic.Stream(mix, seed, vocab, 1, traffic.iw_tiers(mix)) \
            if iw else None
        self.arrivals = traffic.Arrivals(iw["rate_per_s"], seed) if iw \
            else None
        self.stagger = np.random.default_rng([seed % 2**63, 3])
        self.iw_start: Optional[float] = None
        self.next_due = math.inf
        self.live: List[Tracked] = []
        self.done: List[Tracked] = []
        self.iws: List[Tracked] = []
        self.queued_niw = 0
        self.rid = 0
        #: context the engine's step runs in (the traced stretch names it)
        self.step_context: Callable = contextlib.nullcontext

    # ------------------------------------------------------------ intake
    def _submit(self, draw: traffic.Draw, kind: str, due: float) -> Tracked:
        now = float(self.engine.step_count)
        deadline = self.mix["iw"]["deadline_steps"].get(draw.tier, math.inf) \
            if kind == "iw" else math.inf
        req = self.request_cls(rid=self.rid, prompt=draw.prompt,
                               max_new_tokens=draw.max_new_tokens,
                               tier=draw.tier, arrival=now,
                               ttft_deadline=now + deadline)
        self.rid += 1
        tr = Tracked(req, kind, due, self.clock())
        self.engine.submit(req)
        self.live.append(tr)
        return tr

    def fill(self) -> None:
        """Fill every slot at once with batch requests whose outputs are
        cut to a stratified share of their drawn length, so that they
        finish spread over the next steps as in steady state."""
        n = self.mix["slots"]
        shares = self.stagger.permutation((np.arange(n) + 0.5) / n)
        now = self.clock()
        for u in shares:
            d = self.niw.next()
            d.max_new_tokens = max(2, int(math.ceil(u * d.max_new_tokens)))
            self._submit(d, "fill", now)

    def start_iw(self) -> None:
        """Start the open-loop interactive stream now."""
        if self.arrivals is not None:
            self.iw_start = self.clock()
            self.next_due = self.iw_start + self.arrivals.next()

    def release(self, now: float, until: float = math.inf) -> None:
        """Submit every IW request due by ``now`` (and before ``until``)."""
        while self.next_due <= min(now, until - 1e-12):
            self.iws.append(self._submit(self.iw.next(), "iw",
                                         self.next_due))
            self.next_due = self.iw_start + self.arrivals.next()

    def top_up(self) -> None:
        while self.queued_niw < self.mix["niw"]["depth"]:
            self._submit(self.niw.next(), "niw", self.clock())
            self.queued_niw += 1

    # ------------------------------------------------------------- steps
    def step(self, release_until: float = math.inf) -> StepRec:
        self.release(self.clock(), release_until)
        self.top_up()
        start = self.clock()
        with self.step_context():
            self.engine.step()
        end = self.clock()
        rec = StepRec(start, end, [], [])
        live = []
        for tr in self.live:
            r, seen = tr.req, len(tr.times)
            n = len(r.tokens)
            if n > seen:
                if seen == 0:
                    rec.prompts.append(len(r.prompt))
                    tr.admit_start = start
                    if tr.kind == "niw":
                        self.queued_niw -= 1
                if n - seen - (seen == 0) > 0:   # a decode token this step
                    rec.contexts.append(len(r.prompt) + n - 2)
                tr.times.extend([end] * (n - seen))
            (self.done if r.done_step is not None else live).append(tr)
        self.live = live
        return rec

    def tracked(self) -> List[Tracked]:
        return self.done + self.live


@dataclasses.dataclass
class Window:
    """What the measured window saw: its span, its steps and requests."""

    t0: float
    t_end: float
    seconds: float
    steps: List[StepRec]
    requests: List[Tracked]
    iw: List[Tracked]            # IW requests due inside the window
    generator_late_s: float      # the most an IW submit came after its due
    drain_end: float             # when the harness stopped waiting for IW

    def ttft(self, tr: Tracked) -> float:
        """Due to first token; a request never served counts the whole
        wait, until the harness stopped waiting."""
        return tr.ttft if tr.times else self.drain_end - tr.due

    def attempted(self) -> int:
        """Requests due (IW) or admitted (the backlog) inside the window."""
        return sum(1 for tr in self.requests
                   if (self.t0 <= tr.due < self.t0 + self.seconds
                       if tr.kind == "iw"
                       else self.t0 <= tr.admit_start <= self.t_end))

    def plain_step_s(self) -> Optional[float]:
        """The mean host time of the window's steps that admitted
        nothing, each a decode of every slot."""
        spans = [s.end - s.start for s in self.steps if not s.prompts]
        return sum(spans) / len(spans) if spans else None

    def prompt_token_s(self) -> Optional[float]:
        """The host time the window's admitting steps took beyond a step
        that admitted nothing, per prompt token they admitted."""
        plain = self.plain_step_s()
        admitting = [s for s in self.steps if s.prompts]
        if plain is None or not admitting:
            return None
        return sum(s.end - s.start - plain for s in admitting) \
            / sum(sum(s.prompts) for s in admitting)

    def predict_s(self, steps: List[StepRec]) -> Optional[float]:
        """The host time the window's own step times give for ``steps``:
        a step that admitted nothing each, plus the extra time a prompt
        token for every token they admitted."""
        plain = self.plain_step_s()
        if plain is None:
            return None
        per_token = self.prompt_token_s() or 0.0
        return sum(plain + per_token * sum(s.prompts) for s in steps)

    def missing(self) -> int:
        return sum(1 for tr in self.iw if not tr.times)

    def tokens(self) -> int:
        return sum(1 for tr in self.requests for t in tr.times
                   if self.t0 < t <= self.t_end)

    def gaps(self) -> List[float]:
        """Every gap between consecutive visible tokens of a request whose
        later token became visible inside the window."""
        out = []
        for tr in self.requests:
            ts = tr.times
            out.extend(b - a for a, b in zip(ts, ts[1:])
                       if self.t0 < b <= self.t_end)
        return out


def measure(drv: Clients, seconds: float,
            on_close: Optional[Callable[[float], None]] = None,
            drain_s: float = 60.0) -> Window:
    """Step for ``seconds`` from now; then, with no new IW request
    released past the window, step until every IW request due inside it
    has its first token, or ``drain_s`` has passed.  ``on_close(until)``
    runs when the window closes, before the drain."""
    t0 = drv.clock()
    until = t0 + seconds
    steps = []
    while drv.clock() < until:
        steps.append(drv.step(release_until=until))
    t_end = steps[-1].end
    if on_close is not None:
        on_close(until)
    iw = [tr for tr in drv.iws if t0 <= tr.due < until]
    stop = drv.clock() + drain_s
    while (drv.next_due < until
           or any(not tr.times for tr in iw)) and drv.clock() < stop:
        drv.step(release_until=until)
        iw = [tr for tr in drv.iws if t0 <= tr.due < until]
    late = max((tr.submitted - tr.due for tr in iw), default=0.0)
    return Window(t0, t_end, seconds, steps, drv.tracked(), iw, late,
                  drv.clock())
