"""transcript_s: seconds a step in the host transcript, a span around each
absorb and sample method of `Transcript` and of the collector's
`ReplayTranscript`, and the device Fiat-Shamir's export and import (a
call inside another counts once)."""

_M = "latticeum_tpu_torch.zkvm.prover"
_T = ("absorb_ring", "absorb_slice", "absorb_u64", "absorb_fq3",
      "get_challenge", "squeeze_bytes", "get_short_challenge",
      "export_for_device", "import_from_device")
_R = ("absorb_ring", "absorb_slice", "absorb_u64", "absorb_fq3",
      "get_challenge")
TARGETS = {"transcript_s": [(_M, f"Transcript.{m}") for m in _T]
           + [(_M, f"ReplayTranscript.{m}") for m in _R]}


def read(w):
    return w.span_per_step("transcript_s")
