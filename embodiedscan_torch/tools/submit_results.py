"""Challenge submission packer (the reference package's
``tools/submit_results.py``): wraps a results file with the team's
metadata into the submission pkl. Host only.

Usage:
    python -m embodiedscan_torch.tools.submit_results --results r.json \\
        --out submission.pkl [--method M] [--team T] [--authors a,b] ...
"""

import argparse
import json
import pickle


def main(argv=None) -> dict:
    """Packs as ``argv`` (default: the command line) asks; returns the
    submission written."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--results', required=True,
                        help='json/pkl of per-sample predictions')
    parser.add_argument('--out', required=True, help='output pkl path')
    parser.add_argument('--method', default='embodiedscan-torch')
    parser.add_argument('--team', default='')
    parser.add_argument('--authors', default='')
    parser.add_argument('--email', default='')
    parser.add_argument('--institution', default='')
    parser.add_argument('--country', default='')
    args = parser.parse_args(argv)

    if args.results.endswith('.json'):
        with open(args.results) as f:
            results = json.load(f)
    else:
        with open(args.results, 'rb') as f:
            results = pickle.load(f)

    submission = dict(
        method=args.method,
        team=args.team,
        authors=args.authors.split(',') if args.authors else [],
        e_mail=args.email,
        institution_or_company=args.institution,
        country_or_region=args.country,
        results=results,
    )
    with open(args.out, 'wb') as f:
        pickle.dump(submission, f)
    print(f'wrote {args.out} ({len(results)} entries)')
    return submission


if __name__ == '__main__':
    main()
