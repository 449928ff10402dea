"""zkVM CLI of the torch port: prove a RISC-V guest end to end.

Usage:
    python -m latticeum_tpu_torch.zkvm.cli --guest path/to/elf [--debug]
    python -m latticeum_tpu_torch.zkvm.cli --builtin fib100 [--max-steps N]

Counterpart of ``latticeum_tpu/zkvm/cli.py``: loads the guest into a VM,
folds every executed instruction into the running LatticeFold accumulator
with ``TorchZkVmProver`` on one CUDA card (``--device cpu`` runs the plain
torch versions of the kernels on the CPU instead), prints each step's time
and ends with one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="latticeum zkVM prover, torch")
    ap.add_argument("--guest", help="path to a riscv32imac ELF guest")
    ap.add_argument("--builtin", choices=["fib100", "fib-loop"],
                    help="use a built-in synthesized guest")
    ap.add_argument("--fib-n", type=int, default=100)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--debug", action="store_true",
                    help="check the CCS relation and verify every fold")
    ap.add_argument("--vm-size", choices=["1mb", "4mb", "8mb"], default="8mb")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the prover runs (default: the CUDA card)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    from ..host.vm.vm import new_vm_1mb, new_vm_4mb, new_vm_8mb
    from .prover import TorchZkVmProver

    vm = {"1mb": new_vm_1mb, "4mb": new_vm_4mb, "8mb": new_vm_8mb}[
        args.vm_size]()
    if args.guest:
        vm.load_elf_file(args.guest)
    elif args.builtin == "fib100":
        from ..host.vm.assembler import fib_const_guest
        vm.load_elf_data(fib_const_guest(0xC594BFC3))
    elif args.builtin == "fib-loop":
        from ..host.vm.assembler import fib_loop_guest
        vm.load_elf_data(fib_loop_guest(args.fib_n))
    else:
        ap.error("one of --guest / --builtin is required")

    print("building CCS + prover ...", flush=True)
    prover = TorchZkVmProver(debug=args.debug, device=args.device)
    t0 = time.time()

    def on_step(step, state):
        dt = prover.timings["step_times"][-1]
        print(f"step {step}: {dt:.1f}s", flush=True)

    state = prover.prove_vm(vm, max_steps=args.max_steps, on_step=on_step,
                            checkpoint_dir=args.checkpoint_dir,
                            resume=args.resume)
    total = time.time() - t0
    print(json.dumps({
        "steps_folded": state.steps,
        "result": hex(vm.result()),
        "total_seconds": round(total, 2),
        "seconds_per_step": round(total / max(state.steps, 1), 2),
        "acc_comm": state.acc_comm,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
