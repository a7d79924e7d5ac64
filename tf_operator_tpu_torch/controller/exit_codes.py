"""Exit-code classification for the ExitCode restart policy.

Behavioral parity with reference vendor/.../util/train/train_util.go:18-53:
permanent errors fail the replica; retryable errors restart it in place.
"""

# Permanent: shell/general errors and SIGSEGV (train_util.go:19-30).
PERMANENT_EXIT_CODES = frozenset({1, 2, 126, 127, 128, 139})

# Retryable: transient-signal terminations SIGINT/SIGKILL/SIGTERM
# (train_util.go:32-43) plus SIGUSR1 as the user-defined retryable code
# (train_util.go:45-49).
RETRYABLE_EXIT_CODES = frozenset({130, 137, 143, 138})


def is_retryable_exit_code(exit_code: int) -> bool:
    if exit_code in PERMANENT_EXIT_CODES:
        return False
    if exit_code in RETRYABLE_EXIT_CODES:
        return True
    # No guarantee for other codes: treated as permanent (train_util.go:51-52).
    return False
