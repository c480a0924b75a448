import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from mvbench.run import main

    sys.exit(main(T_START))
