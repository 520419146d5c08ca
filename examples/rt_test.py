#!/usr/bin/env python3
"""Sample host application for the async render API — the `rt_test_dll`
equivalent (rt_test_dll/rt_test_dll.cpp:13-44): start a stereo render of a
Collada file, poll status, optionally force-stop after a timeout.

Usage: python examples/rt_test.py scene.dae [--stop-after SECONDS]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))

from yulio_raytracer.api import session as rt  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('collada')
    ap.add_argument('--stop-after', type=float, default=0.0,
                    help='force StopRT(keepResults=True) after N seconds')
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--spp', type=int, default=16)
    ap.add_argument('--depth', type=int, default=6)
    args = ap.parse_args()

    params = rt.ParamsRT(size=args.size, spp=args.spp, depth=args.depth,
                         watermark=True)
    if not rt.StartRT(args.collada, params):
        print(f"StartRT failed: {rt.GetLastErrorRT().name}",
              file=sys.stderr)
        return 1

    t0 = time.time()
    while True:
        st = rt.GetCurrentStatusRT()
        print(f"\r[{st.state.name:13s}] {st.progress * 100:5.1f}%",
              end='', flush=True)
        if st.state in (rt.StateRT.Done, rt.StateRT.Stopped):
            break
        if args.stop_after and time.time() - t0 > args.stop_after:
            print("\nforcing StopRT(keepResults=True)")
            rt.StopRT(True)
            break
        time.sleep(0.5)
    rt.WaitRT()
    st = rt.GetCurrentStatusRT()
    print(f"\nfinal state: {st.state.name}, last error: "
          f"{rt.GetLastErrorRT().name}")
    return 0 if st.state == rt.StateRT.Done else 1


if __name__ == '__main__':
    sys.exit(main())
