"""How many kernel launches the host queues behind a running kernel
before a launch blocks: the host's ms to queue n tiny kernels behind a
sleep kernel of about a second, for n from 64 to 4096.  A launch that
blocks waits for the sleep, so its n reads about the sleep's ms.  This
caps how much work one ``chip_smoke.time_ms`` measurement may queue.

Run on a machine with a CUDA card: ``python3 tools/chip_launch_queue.py``.
"""

import subprocess
import time

import torch


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    x = torch.zeros(1, device="cuda")
    x.add_(1)  # loads the kernel before the first timed queue
    for n in (64, 128, 256, 512, 768, 1000, 1024, 1100, 1536, 2048, 4096):
        torch.cuda.synchronize()
        s, a = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(1 << 31)
        a.record()
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        print("%d launches queued in %.3f ms behind a %.1f ms sleep"
              % (n, host, s.elapsed_time(a)), flush=True)


if __name__ == "__main__":
    main()
